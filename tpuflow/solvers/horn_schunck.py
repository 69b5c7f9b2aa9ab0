"""Horn-Schunck dense variational optical flow.

Two variants:

- :func:`horn_schunck` — behavioral parity with the reference demo
  (``HornSchunckOF/hornSchunck.cpp:19-75``): 3x3 Sobel gradients of the
  *previous* frame only, ``gT = next - prev``, then ``max_iterations``
  Jacobi sweeps where the neighborhood average is a ``window_size``²
  box filter with BORDER_CONSTANT(0):

      ubar = box(u); vbar = box(v)
      upd  = (gX*ubar + gY*vbar + gT) / (alpha² + gX² + gY²)
      u    = ubar - gX*upd;  v = vbar - gY*upd

  Defaults (5, 100, 1.0) from ``HornSchunckOF/main.cpp:94-96``.

- :func:`horn_schunck_classic` — the textbook 1981 formulation with the
  weighted 4/8-neighbor Laplacian average, for users who want the standard
  algorithm rather than demo parity.

Device paths (:mod:`tpuflow.core.backend`): :func:`horn_schunck` runs
its sweeps as a ``lax.fori_loop`` of two box convolutions plus pointwise
algebra (:func:`horn_schunck_conv`), or on the GPU in the temporally
blocked CUDA kernel (:mod:`tpuflow.kernels.hs_cuda`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.core import backend
from tpuflow.core import borders as bd
from tpuflow.kernels import hs_cuda
from tpuflow.ops.derivatives import sobel_opencv
from tpuflow.ops.filters import box_filter, conv2d


def hs_gradients(prev: jnp.ndarray, next: jnp.ndarray):
    """(gX, gY, gT) per hornSchunck::getGradients (hornSchunck.cpp:19-41)."""
    gx = sobel_opencv(prev, "x")
    gy = sobel_opencv(prev, "y")
    gt = next - prev
    return gx, gy, gt


def horn_schunck(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    window_size: int = 5,
    max_iterations: int = 100,
    alpha: float = 1.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Box-average Jacobi HS, parity with hornSchunck::getFlow.

    Runs the CUDA kernel where the backend takes it
    (:func:`tpuflow.core.backend.paths`) and it implements the window
    and dtype, else :func:`horn_schunck_conv`."""
    if (backend.paths().hs_kernel
            and hs_cuda.supports(window_size, jnp.result_type(prev, next))):
        return horn_schunck_kernel(prev, next, window_size, max_iterations,
                                   alpha)
    return horn_schunck_conv(prev, next, window_size, max_iterations, alpha)


@partial(jax.jit, static_argnames=("window_size", "max_iterations"))
def horn_schunck_kernel(prev, next, window_size: int = 5,
                        max_iterations: int = 100, alpha: float = 1.0):
    """:func:`horn_schunck` with the sweeps in the CUDA kernel (GPU only,
    float32)."""
    gx, gy, gt = hs_gradients(prev, next)
    inv = 1.0 / (alpha * alpha + gx * gx + gy * gy)
    return hs_cuda.hs_sweeps_cuda(gx, gy, gt, inv, max_iterations,
                                  window_size)


@partial(jax.jit, static_argnames=("window_size", "max_iterations"))
def horn_schunck_conv(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    window_size: int = 5,
    max_iterations: int = 100,
    alpha: float = 1.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`horn_schunck` as one box convolution per field per sweep."""
    gx, gy, gt = hs_gradients(prev, next)
    denom = alpha * alpha + gx * gx + gy * gy
    gx_n = gx / denom
    gy_n = gy / denom
    u0 = jnp.zeros_like(gt)
    v0 = jnp.zeros_like(gt)

    def body(_, uv):
        u, v = uv
        ubar = box_filter(u, window_size, border=bd.ZERO)
        vbar = box_filter(v, window_size, border=bd.ZERO)
        upd = gx_n * ubar + gy_n * vbar + gt / denom
        # Algebra matches (gX*ubar + gY*vbar + gT)/denom then u = ubar - gX*upd.
        return ubar - gx * upd, vbar - gy * upd

    return jax.lax.fori_loop(0, max_iterations, body, (u0, v0))


_HS_LAPLACIAN = np.array(
    [[1 / 12, 1 / 6, 1 / 12], [1 / 6, 0.0, 1 / 6], [1 / 12, 1 / 6, 1 / 12]]
)


@partial(jax.jit, static_argnames=("max_iterations",))
def horn_schunck_classic(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    max_iterations: int = 100,
    alpha: float = 1.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Classic Horn-Schunck 1981: weighted-Laplacian neighborhood average,
    centered spatio-temporal gradients averaged over both frames."""
    # Horn-Schunck forward-difference gradient cube averaged over 4 samples.
    kx = jnp.array([[-0.25, 0.25], [-0.25, 0.25]], dtype=prev.dtype)
    ky = jnp.array([[-0.25, -0.25], [0.25, 0.25]], dtype=prev.dtype)
    gx = conv2d(prev, kx, bd.CLAMP, anchor=(0, 0)) + conv2d(next, kx, bd.CLAMP, anchor=(0, 0))
    gy = conv2d(prev, ky, bd.CLAMP, anchor=(0, 0)) + conv2d(next, ky, bd.CLAMP, anchor=(0, 0))
    kt = jnp.full((2, 2), 0.25, dtype=prev.dtype)
    gt = conv2d(next, kt, bd.CLAMP, anchor=(0, 0)) - conv2d(prev, kt, bd.CLAMP, anchor=(0, 0))
    denom = alpha * alpha + gx * gx + gy * gy
    u0 = jnp.zeros_like(gt)
    v0 = jnp.zeros_like(gt)
    lap = _HS_LAPLACIAN.astype(prev.dtype)

    def body(_, uv):
        u, v = uv
        ubar = conv2d(u, lap, bd.CLAMP)
        vbar = conv2d(v, lap, bd.CLAMP)
        upd = (gx * ubar + gy * vbar + gt) / denom
        return ubar - gx * upd, vbar - gy * upd

    return jax.lax.fori_loop(0, max_iterations, body, (u0, v0))
