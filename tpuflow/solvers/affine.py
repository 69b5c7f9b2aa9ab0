"""Global affine parametric motion (6-parameter IRLS).

Re-design of ``OpticalFlow/Affine_MultipleMotion.cpp``: the flow field is
u = a0 + a1 x + a2 y, v = a3 + a4 y + a5 y over the whole frame; the six
coefficients are fitted coarse-to-fine by robust gradient descent:

- sigmaD = 0.1 * sqrt(3) (Affine_MultipleMotion.cpp:18);
- pyramids + dt + *two-frame summed* gradients (grad_Pyramid(It, Itp1),
  :68);
- per level: a0, a3 *= 2 (:79-80), IterMax = 2 * max(W_l, H_l) (:81);
- update a_i -= omega / sup_i * dE_i with omega = 1e-4, the tiny-sup
  guard (|sup| < 1e-16 -> omega / 1e-16 * sign(sup)), and
  sup_i = 2 max_site (g_i x^p y^q)^2 / sigmaD^2 (:121-134, 175-222);
- dE_i = sum_site basis_i * psi_GM(g.u_a + I_t, sigmaD) (:148-172);
- stop on E < threshold.

Design: each iteration is a full-image reduction of 6 moments — a
(H*W, 6) basis contraction; the loop is a
``lax.while_loop`` carrying the 6-vector.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.core.config import MultipleMotionParam
from tpuflow.pyramid import dt_pyramid, grad_pyramid, pyramider
from tpuflow.solvers.mestimators import geman_mcclure_psi, geman_mcclure_rho

SIGMA_D_AFFINE = 0.1 * math.sqrt(3.0)
NUM_AFFINE_PARAMETER = 6


def _coords(h: int, w: int, dtype):
    x = jnp.arange(w, dtype=dtype)[None, :] * jnp.ones((h, 1), dtype)
    y = jnp.arange(h, dtype=dtype)[:, None] * jnp.ones((1, w), dtype)
    return x, y


def _basis(gx, gy, x, y):
    """The six gradient basis fields: [gx, gx*x, gx*y, gy, gy*x, gy*y]."""
    return jnp.stack([gx, gx * x, gx * y, gy, gy * x, gy * y], axis=0)


def affine_flow_field(a: jnp.ndarray, h: int, w: int):
    """Evaluate u = a0 + a1 x + a2 y, v = a3 + a4 x + a5 y on the grid."""
    x, y = _coords(h, w, a.dtype)
    u = a[0] + a[1] * x + a[2] * y
    v = a[3] + a[4] * x + a[5] * y
    return u, v


def affine_energy(a, gx, gy, it, sigma_d):
    h, w = gx.shape
    u, v = affine_flow_field(a, h, w)
    return jnp.sum(geman_mcclure_rho(gx * u + gy * v + it, sigma_d))


@partial(jax.jit, static_argnames=("iter_max",))
def irls_affine_level(a0, gx, gy, it, sigma_d, iter_max: int,
                      error_min_threshold: float):
    """IRLS_MultipleMotion_Affine (Affine_MultipleMotion.cpp:108-145)."""
    h, w = gx.shape
    x, y = _coords(h, w, gx.dtype)
    basis = _basis(gx, gy, x, y)  # (6, H, W)
    sup = 2.0 * jnp.max(basis * basis, axis=(1, 2)) / sigma_d**2  # (6,)
    omega = jnp.asarray(1.0e-4, gx.dtype)
    tiny = 1.0e-16
    step = jnp.where(jnp.abs(sup) < tiny,
                     omega / tiny * jnp.sign(sup + jnp.where(sup >= 0, tiny, -tiny)),
                     omega / sup)

    def cond(carry):
        a, E, n, stop = carry
        return jnp.logical_and(n < iter_max, jnp.logical_not(stop))

    def body(carry):
        a, E, n, _ = carry
        u, v = affine_flow_field(a, h, w)
        psi = geman_mcclure_psi(gx * u + gy * v + it, sigma_d)  # (H, W)
        dE = jnp.sum(basis * psi[None], axis=(1, 2))  # (6,)
        a = a - step * dE
        E_new = affine_energy(a, gx, gy, it, sigma_d)
        return a, E_new, n + 1, E_new < error_min_threshold

    big = jnp.asarray(jnp.inf, gx.dtype)
    a, E, n, _ = jax.lax.while_loop(
        cond, body, (a0, big, jnp.int32(0), jnp.bool_(False)))
    return a, E, n


def multiple_motion_affine(
    it_img: jnp.ndarray,
    itp1_img: jnp.ndarray,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
) -> jnp.ndarray:
    """Full coarse-to-fine affine fit; returns the 6-vector a.

    Parity with MultipleMotion_Affine (Affine_MultipleMotion.cpp:12-105).
    """
    if param is None:
        param = MultipleMotionParam()
    it_n = it_img / max_int
    itp1_n = itp1_img / max_int
    it_levels = pyramider(it_n, param.level)
    itp1_levels = pyramider(itp1_n, param.level)
    max_level = len(it_levels) - 1
    dt_levels = dt_pyramid(it_levels, itp1_levels)
    grad_levels = grad_pyramid(it_levels, itp1_levels)  # two-frame sum

    a = jnp.zeros((NUM_AFFINE_PARAMETER,), it_n.dtype)
    for level in range(max_level, -1, -1):
        a = a.at[0].mul(2.0)
        a = a.at[3].mul(2.0)
        gx, gy = grad_levels[level]
        it_l = dt_levels[level]
        iter_max = 2 * max(it_l.shape[0], it_l.shape[1])
        a, _, _ = irls_affine_level(
            a, gx, gy, it_l, SIGMA_D_AFFINE, iter_max,
            param.error_min_threshold)
    return a
