#!/usr/bin/env python3
"""Sweep the HS CUDA kernel's blocking on one NVIDIA GPU, against XLA.

    python scripts/hs_blocking_sweep.py

Builds tpuflow/kernels/hs_sweeps.cu once per (K sweeps per launch, tile
rows, tile cols) with -D overrides into build/sweep/, checks each build
against solvers.horn_schunck_conv on a ragged 600x1000 frame (37 sweeps,
windows 3, 5 and 7), then times 100 sweeps 5x5 at 1920x1080 and
3840x2160: every build, solvers.horn_schunck (the compiled blocking),
horn_schunck_conv, and chip_smoke.hs_fused at fuse 5 and 10. Times are
the median of 7 calls in ms per frame. This is the evidence for the
blocking compiled into the library (hs_cuda.BLOCKING) and for keeping
the kernel at all.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

VARIANTS = ((2, 32, 128), (3, 32, 128), (4, 32, 64), (4, 32, 128),
            (4, 64, 64), (5, 32, 128), (6, 32, 128), (8, 32, 128))
SIZES = ((1080, 1920), (2160, 3840))
_LOADED: list = []  # keeps each loaded build alive


def build(blocking) -> Path:
    from tpuflow.kernels import hs_cuda

    k, th, tw = blocking
    out = hs_cuda.BUILD_DIR / "sweep" / f"libhs_sweeps-k{k}-{th}x{tw}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = hs_cuda.nvcc_command(hs_cuda.SOURCE, out)
    cmd[1:1] = [f"-DHS_BLOCK_SWEEPS={k}", f"-DHS_TILE_H={th}",
                f"-DHS_TILE_W={tw}"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {blocking}:\n{proc.stderr}")
    return out


def register(blocking, path: Path) -> str:
    """Load one build (its own symbol scope) as an FFI target."""
    import jax

    lib = ctypes.CDLL(str(path))
    name = "tpuflow_hs_sweeps_k{}_{}x{}".format(*blocking)
    jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(lib.HsSweeps),
                                platform="CUDA")
    _LOADED.append(lib)
    return name


def median_ms(fn, reps=7) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main() -> int:
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("no GPU", file=sys.stderr)
        return 2
    from chip_smoke import hs_fused, nvidia_smi_line
    from tpuflow.core.synthetic import layered_pair
    from tpuflow.solvers import horn_schunck, horn_schunck_conv
    from tpuflow.solvers.horn_schunck import hs_gradients

    print(nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = list(pool.map(build, VARIANTS))
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    targets = {b: register(b, p) for b, p in zip(VARIANTS, paths)}

    @partial(jax.jit, static_argnames=("target", "iters", "window"))
    def kernel(p, n, target, iters, window):
        gx, gy, gt = hs_gradients(p, n)
        inv = 1.0 / (1.0 + gx * gx + gy * gy)
        plane = jax.ShapeDtypeStruct(p.shape, jnp.float32)
        scratch = jax.ShapeDtypeStruct((2, *p.shape), jnp.float32)
        u, v, _ = jax.ffi.ffi_call(target, (plane, plane, scratch))(
            gx, gy, gt, inv, iterations=np.int64(iters),
            radius=np.int64(window // 2))
        return u, v

    p, n, _, _ = layered_pair(600, 1000, seed=3)
    p, n = jnp.asarray(p, jnp.float32), jnp.asarray(n, jnp.float32)
    worst = 0.0
    for window in (3, 5, 7):
        u0, v0 = horn_schunck_conv(p, n, window, 37, 1.0)
        for b, target in targets.items():
            u, v = kernel(p, n, target, 37, window)
            err = float(max(jnp.max(jnp.abs(u - u0)),
                            jnp.max(jnp.abs(v - v0))))
            worst = max(worst, err)
            print(f"check window {window} K{b[0]} {b[1]}x{b[2]}: "
                  f"max |kernel - conv| {err:.2e}", flush=True)
    if not worst <= 1e-4:
        print(f"FAILED: a build is off the conv path by {worst:.2e}",
              file=sys.stderr)
        return 1

    for h, w in SIZES:
        p, n, _, _ = layered_pair(h, w, seed=21)
        p, n = jnp.asarray(p, jnp.float32), jnp.asarray(n, jnp.float32)
        rows = {
            "horn_schunck_conv": lambda: horn_schunck_conv(p, n, 5, 100, 1.0),
            "hs_fused fuse 5": lambda: hs_fused(p, n, 5, 100, 1.0, fuse=5),
            "hs_fused fuse 10": lambda: hs_fused(p, n, 5, 100, 1.0, fuse=10),
            "solvers.horn_schunck": lambda: horn_schunck(p, n, 5, 100, 1.0),
        }
        for b, target in targets.items():
            rows[f"kernel K{b[0]} {b[1]}x{b[2]}"] = partial(
                kernel, p, n, target, 100, 5)
        for label, fn in rows.items():
            print(f"time {w}x{h} {label}: {median_ms(fn):.3f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
