"""Weak-scaling measurement harness.

Runs the distributed Horn-Schunck relaxation at a per-device-constant
problem size over growing sub-meshes and reports throughput + efficiency:

    report = weak_scaling_report(tile_hw=(1024, 1024), iterations=50)

Efficiency_n = t_1 / t_n for n devices (1.0 = perfect weak scaling).
Runs on anything `jax.devices()` exposes — the virtual CPU mesh validates
the logic; times come only from a run on GPUs.
"""

from __future__ import annotations

import time

import jax
import numpy as np
from jax.sharding import Mesh

from tpuflow.dist.mesh import mesh_factor
from tpuflow.dist.solvers import horn_schunck_sharded_fused


def _submeshes(devices) -> list[tuple[int, int]]:
    """Power-of-two device counts up to len(devices), as 2-D factors."""
    counts = []
    n = 1
    while n <= len(devices):
        counts.append(n)
        n *= 2
    return [mesh_factor(c) for c in counts]


def weak_scaling_report(
    tile_hw: tuple[int, int] = (512, 512),
    iterations: int = 50,
    window_size: int = 5,
    fuse: int = 5,
    repeats: int = 3,
    devices=None,
) -> dict:
    """Time the fused distributed HS at tile_hw *per device*."""
    if devices is None:
        devices = jax.devices()
    th, tw = tile_hw
    rows = []
    t_base = None
    for ty, tx in _submeshes(devices):
        n = ty * tx
        mesh = Mesh(np.array(devices[:n]).reshape(ty, tx), ("ty", "tx"))
        h, w = th * ty, tw * tx
        rng = np.random.default_rng(0)
        prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
        nxt = np.roll(prev, 2, axis=1)
        # Pre-place the inputs with the mesh sharding: host->device
        # transfer is NOT part of the solve.
        from jax.sharding import NamedSharding

        from tpuflow.dist.solvers import SPEC

        sharding = NamedSharding(mesh, SPEC)
        prev_d = jax.device_put(prev, sharding)
        nxt_d = jax.device_put(nxt, sharding)

        def run():
            return horn_schunck_sharded_fused(
                prev_d, nxt_d, mesh, window_size, iterations, 1.0, fuse)

        np.asarray(run()[0][:1, :1])  # compile + hard sync
        t0 = time.perf_counter()
        for _ in range(repeats):
            u, _ = run()
        # One tiny hard fetch after queueing every repeat: the device
        # executes dispatches in order, so fetching any element of the
        # last result forces them all.
        np.asarray(u[:1, :1])
        dt = (time.perf_counter() - t0) / repeats
        if t_base is None:
            t_base = dt
        rows.append({
            "devices": n, "mesh": [ty, tx], "image": [h, w],
            "seconds": dt,
            "mpix_per_s": h * w * iterations / dt / 1e6,
            "efficiency": t_base / dt,
        })
    return {"tile": list(tile_hw), "iterations": iterations, "runs": rows}
