"""Horn-Schunck sweeps through the CUDA kernel in ``hs_sweeps.cu``.

Route: CUDA C++ built for ``sm_90a`` with ``nvcc`` and called as a JAX
operation through the XLA foreign function interface (``jax.ffi``). The
kernel keeps u and v of a halo tile in shared memory for ``K`` sweeps
per launch (see the source's header). The library is built from the
source in this package into ``<checkout>/build/`` at first use; the
file name carries a hash of the source, so an edited source rebuilds.
A failed build or load raises: there is no fallback to the jnp path.
Under ``jax.vmap`` the operation runs once per batch element.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

SOURCE = Path(__file__).with_name("hs_sweeps.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
TARGET = "tpuflow_hs_sweeps"

#: Compiled window radii; the same as ``kByRadius`` in hs_sweeps.cu.
RADII = (1, 2, 3)
#: Sweeps per launch and tile (th, tw) of the compiled kernel
#: (``kBlockSweeps``, ``kTileH``, ``kTileW`` in hs_sweeps.cu).
BLOCKING = (4, 32, 64)


def supports(window_size: int, dtype) -> bool:
    """Whether the kernel implements this window and dtype."""
    return (window_size % 2 == 1 and window_size // 2 in RADII
            and jnp.dtype(dtype) == jnp.float32)


def nvcc_command(src: Path, out: Path) -> list[str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", str(out), str(src)]


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return build_dir / f"libhs_sweeps-{digest}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernel library unless this source's build exists."""
    out = library_path(build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(SOURCE, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {SOURCE.name} (exit {proc.returncode}):"
            f"\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: no process loads a partial file
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.HsSweeps),
                                platform="CUDA")
    return lib


def hs_sweeps_cuda(gx, gy, gt, inv, iterations: int, window_size: int):
    """``iterations`` HS sweeps from zero flow on the card; returns (u, v).

    ``gx, gy, gt, inv`` are float32 (H, W) fields (``inv`` =
    1 / (alpha^2 + gx^2 + gy^2))."""
    if not supports(window_size, gx.dtype):
        raise ValueError(f"no HS kernel for window {window_size}, "
                         f"{jnp.dtype(gx.dtype)}")
    _library()
    h, w = gx.shape
    plane = jax.ShapeDtypeStruct((h, w), jnp.float32)
    scratch = jax.ShapeDtypeStruct((2, h, w), jnp.float32)
    u, v, _ = jax.ffi.ffi_call(TARGET, (plane, plane, scratch),
                               vmap_method="sequential")(
        gx, gy, gt, inv, iterations=np.int64(iterations),
        radius=np.int64(window_size // 2))
    return u, v

