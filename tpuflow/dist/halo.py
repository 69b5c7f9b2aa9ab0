"""Halo exchange for tiled stencil computation under shard_map.

Each device owns an (H/ty, W/tx) tile; stencil ops of radius r need the
r-pixel border of the four neighbors. :func:`halo_pad_2d` exchanges halos
with ``lax.ppermute`` neighbor shifts (NVLink between the GPUs of a
host, the network across hosts): x-strips first, then y-strips carrying the corners.
Non-periodic boundaries receive zeros — exactly the reference's
BORDER_CONSTANT / get_zeropad convention (ppermute leaves devices without
a source as zeros), so a zero-border stencil on the halo-padded tile is
bit-identical to the single-device solve (SURVEY.md §2.6).

This is the explicit path used by the fused multi-sweep kernels (k sweeps
per exchange need k-wide halos). For one-shot ops, plain ``jit`` with
NamedSharding annotations lets XLA GSPMD insert the same exchanges
automatically — see :mod:`tpuflow.dist.solvers`.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def shift_along(x: jnp.ndarray, axis_name: str, direction: int) -> jnp.ndarray:
    """Move data one step along a mesh axis.

    direction=+1: device i's data arrives at device i+1 (receive from the
    left/top neighbor); devices with no source receive zeros.
    """
    n = lax.axis_size(axis_name)
    if n == 1:
        return jnp.zeros_like(x)
    if direction == 1:
        perm = [(i, i + 1) for i in range(n - 1)]
    else:
        perm = [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(x, axis_name, perm)


def halo_pad_2d(tile: jnp.ndarray, r: int,
                ty_axis: str = "ty", tx_axis: str = "tx") -> jnp.ndarray:
    """Pad a (h, w) tile to (h + 2r, w + 2r) with neighbor halos.

    Call inside shard_map over a ("ty", "tx") mesh. Global borders get
    zeros (BORDER_CONSTANT semantics).
    """
    # x direction: left halo = right strip of left neighbor, moved +1 in tx.
    left = shift_along(tile[:, -r:], tx_axis, +1)
    right = shift_along(tile[:, :r], tx_axis, -1)
    wide = jnp.concatenate([left, tile, right], axis=1)
    # y direction on the widened tile: corners ride along.
    top = shift_along(wide[-r:, :], ty_axis, +1)
    bottom = shift_along(wide[:r, :], ty_axis, -1)
    return jnp.concatenate([top, wide, bottom], axis=0)
