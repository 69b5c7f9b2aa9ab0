"""Border policies for stencil/window ops.

The reference accesses out-of-range pixels through three distinct policies
(each call site picks one, see SURVEY.md §7.3):

- ``zeropad``  — out-of-range reads return 0
  (ImgVector::get_zeropad, used by the coarse-to-fine warp
  ``OpticalFlow/OpticalFlow.cpp:181-187``).
- ``mirror``   — symmetric reflection including the edge sample
  (ImgVector::get_mirror, used by the pyramid low-pass
  ``OpticalFlow/MultiResolution.cpp:80`` and the generic Filterer
  ``lib/ImgLibrary.cpp:445-464``).
- ``clamp``    — coordinates saturated to the valid range
  (the SATURATE macro, used by the 2x2 gradient stencils
  ``OpticalFlow/MultiResolution.cpp:132-134``).

Additionally the OpenCV demos use BORDER_CONSTANT(0) for filter2D
(``HornSchunckOF/hornSchunck.cpp:60-61``) — same as ``zeropad`` — and
OpenCV's default BORDER_REFLECT_101 for Sobel (edge sample not repeated).

Everything here is pure index/pad arithmetic on static shapes so it fuses
under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

ZERO = "zero"          # out-of-range -> 0
MIRROR = "mirror"      # symmetric incl. edge:  -1 -> 0, -2 -> 1, W -> W-1
REFLECT101 = "reflect101"  # symmetric excl. edge: -1 -> 1, W -> W-2
CLAMP = "clamp"        # saturate to [0, n-1]


def mirror_index(i: jnp.ndarray, n: int) -> jnp.ndarray:
    """Symmetric reflection including the edge (numpy pad mode 'symmetric').

    Periodic with period 2n: ... 2,1,0,0,1,2,...,n-1,n-1,n-2,...
    Matches ImgVector::get_mirror for arbitrarily far out-of-range reads.
    """
    period = 2 * n
    i = jnp.mod(i, period)
    return jnp.where(i >= n, period - 1 - i, i)


def reflect101_index(i: jnp.ndarray, n: int) -> jnp.ndarray:
    """Symmetric reflection excluding the edge (OpenCV BORDER_REFLECT_101)."""
    if n == 1:
        return jnp.zeros_like(i)
    period = 2 * (n - 1)
    i = jnp.mod(jnp.abs(i), period)
    return jnp.where(i >= n, period - i, i)


def clamp_index(i: jnp.ndarray, n: int) -> jnp.ndarray:
    return jnp.clip(i, 0, n - 1)


def pad2d(img: jnp.ndarray, pad: int | tuple[int, int, int, int], mode: str) -> jnp.ndarray:
    """Pad the trailing two (H, W) dims by ``pad`` on each side.

    pad may be an int (same on all sides) or (top, bottom, left, right).
    """
    if isinstance(pad, int):
        pt = pb = pl_ = pr = pad
    else:
        pt, pb, pl_, pr = pad
    widths = [(0, 0)] * (img.ndim - 2) + [(pt, pb), (pl_, pr)]
    if mode == ZERO:
        return jnp.pad(img, widths, mode="constant", constant_values=0)
    if mode == MIRROR:
        return jnp.pad(img, widths, mode="symmetric")
    if mode == REFLECT101:
        return jnp.pad(img, widths, mode="reflect")
    if mode == CLAMP:
        return jnp.pad(img, widths, mode="edge")
    raise ValueError(f"unknown border mode: {mode}")


def _take2d(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    """img[..., ys, xs] for in-range index arrays, as a flat axis-0-style
    take (one flat gather instead of a 2-D fancy-index gather)."""
    h, w = img.shape[-2], img.shape[-1]
    ys, xs = jnp.broadcast_arrays(ys, xs)
    flat_idx = ys * w + xs
    flat = img.reshape(*img.shape[:-2], h * w)
    return jnp.take(flat, flat_idx, axis=-1)


def gather2d(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, mode: str) -> jnp.ndarray:
    """Read img[y, x] (x = column, y = row) under a border policy.

    x/y are integer index arrays of any (broadcastable) shape; out-of-range
    reads resolve per ``mode``. Used for warp gathers (LevelDown, motion
    compensation) where displacements can point anywhere.
    """
    h, w = img.shape[-2], img.shape[-1]
    if mode == ZERO:
        valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        xs = jnp.clip(x, 0, w - 1)
        ys = jnp.clip(y, 0, h - 1)
        vals = _take2d(img, ys, xs)
        return jnp.where(valid, vals, jnp.zeros((), img.dtype))
    if mode == MIRROR:
        return _take2d(img, mirror_index(y, h), mirror_index(x, w))
    if mode == REFLECT101:
        return _take2d(img, reflect101_index(y, h), reflect101_index(x, w))
    if mode == CLAMP:
        return _take2d(img, clamp_index(y, h), clamp_index(x, w))
    raise ValueError(f"unknown border mode: {mode}")
