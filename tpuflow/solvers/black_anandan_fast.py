"""Fast Black-Anandan: the coarse-to-fine IRLS in fused sweep blocks.

Identical math to :func:`tpuflow.solvers.black_anandan.optical_flow_pyramid`
(same pyramids, annealing, LevelDown warp, prolongation, Lipschitz steps),
but each level's relaxation runs in blocks of ``fuse`` shifted-slice
sweeps (:func:`tpuflow.ops.stencil.irls_sweep_fused`) with the energy
stopping test evaluated between blocks:

- level 0: energy every 64 iterations — pick ``fuse`` dividing 64 (default
  16) and the cadence matches the reference exactly (OpticalFlow.cpp:248);
- level > 0: the reference checks energy and the 3-strikes divergence
  counter every iteration; here every ``fuse`` iterations. The descent
  itself is bit-identical — only the early-stop decision is coarser
  (equivalence mode = tpuflow.solvers.black_anandan).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.core.config import MultipleMotionParam
from tpuflow.ops.stencil import irls_sweep_fused
from tpuflow.pyramid import (
    add_vector_offset,
    dt_pyramid,
    grad_pyramid,
    level_down,
    pyramider,
)
from tpuflow.solvers.black_anandan import (
    LAMBDA_D,
    LAMBDA_S,
    SIGMA_D_INIT,
    SIGMA_D_L0,
    SIGMA_S_INIT,
    SIGMA_S_L0,
    irls_energy,
    irls_sup,
)


@partial(jax.jit, static_argnames=("iter_max", "is_level0", "sigma_d",
                                   "sigma_s", "fuse", "sup_mode"))
def irls_level_fast(
    u0, v0, gx, gy, it,
    sigma_d: float, sigma_s: float,
    iter_max: int,
    error_min_threshold: float,
    is_level0: bool,
    fuse: int = 16,
    sup_mode: str = "reference",
):
    """One level: blocks of ``fuse`` fused sweeps + energy stop tests.

    Returns (u, v, E, blocks, trace): ``trace[k]`` is the energy at the
    k-th stop check (after ``(k+1) * check_every`` sweeps) — the fast
    path's version of the reference's E(n) telemetry
    (OpticalFlow.cpp:261-265); NaN past the stopping point.
    """
    sup_x, sup_y = irls_sup(gx, gy, LAMBDA_D, LAMBDA_S, sigma_d, sigma_s,
                            sup_mode)
    check_every = 64 if is_level0 else fuse
    blocks_per_check = max(check_every // fuse, 1)
    n_blocks = -(-iter_max // fuse)
    n_checks = max(-(-n_blocks // blocks_per_check), 1)

    def sweep_block(u, v):
        return irls_sweep_fused(
            u, v, gx, gy, it, sup_x, sup_y, fuse,
            LAMBDA_D, LAMBDA_S, float(sigma_d), float(sigma_s), fuse)

    def energy(u, v):
        return irls_energy(u, v, gx, gy, it, LAMBDA_D, LAMBDA_S,
                           sigma_d, sigma_s)

    def cond(carry):
        u, v, E, inc, b, stop, trace = carry
        return jnp.logical_and(b < n_blocks, jnp.logical_not(stop))

    def body(carry):
        u, v, E, inc, b, _, trace = carry
        u, v = sweep_block(u, v)
        do_check = (b % blocks_per_check) == (blocks_per_check - 1)

        def check(args):
            u, v, E, inc = args
            E_new = energy(u, v)
            inc_new = jnp.where(E_new > E, inc + 1, 0) if not is_level0 \
                else inc
            return E_new, inc_new

        E_new, inc_new = jax.lax.cond(
            do_check, check, lambda args: (args[2], args[3]),
            (u, v, E, inc))
        trace = jax.lax.cond(
            do_check,
            lambda: trace.at[b // blocks_per_check].set(E_new),
            lambda: trace)
        stop = jnp.logical_and(
            do_check,
            jnp.logical_or(E_new < error_min_threshold, inc_new > 3))
        return u, v, E_new, inc_new, b + 1, stop, trace

    E0 = jnp.asarray(0.0, u0.dtype)
    trace0 = jnp.full((n_checks,), jnp.nan, u0.dtype)
    u, v, E, _, b, _, trace = jax.lax.while_loop(
        cond, body, (u0, v0, E0, jnp.int32(0), jnp.int32(0),
                     jnp.bool_(False), trace0))
    return u, v, E, b, trace


def optical_flow_pyramid_fast(
    it_img: jnp.ndarray,
    itp1_img: jnp.ndarray,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    iter_max: int = -1,
    iter_scale: float = 1.0,
    fuse: int = 16,
    energy_trace=None,
    sup_mode: str = "reference",
):
    """Coarse-to-fine Black-Anandan flow in fused sweep blocks.

    ``sup_mode="analytic"`` takes the true Geman-McClure Lipschitz bound
    (~20x the reference's descent rate, same minimizer) — see
    :func:`tpuflow.solvers.black_anandan.irls_sup`."""
    if param is None:
        param = MultipleMotionParam()
    max_level = param.level
    it_n = it_img / max_int
    itp1_n = itp1_img / max_int

    it_levels = pyramider(it_n, max_level)
    itp1_levels = pyramider(itp1_n, max_level)
    max_level = len(it_levels) - 1
    dt_levels = dt_pyramid(it_levels, itp1_levels)
    grad_levels = grad_pyramid(it_levels)

    h0, w0 = it_img.shape
    u = v = None
    for level in range(max_level, -1, -1):
        if max_level > 0:
            sigma_d = SIGMA_D_INIT + (SIGMA_D_L0 - SIGMA_D_INIT) \
                / max_level * (max_level - level)
            sigma_s = SIGMA_S_INIT + (SIGMA_S_L0 - SIGMA_S_INIT) \
                / max_level * (max_level - level)
        else:
            sigma_d, sigma_s = SIGMA_D_L0, SIGMA_S_L0
        gx, gy = grad_levels[level]
        if level < max_level:
            it_l = level_down(it_levels[level], itp1_levels[level], u, v)
        else:
            it_l = dt_levels[level]
        u0 = jnp.zeros_like(it_l)
        v0 = jnp.zeros_like(it_l)
        iters = int((level + 1) * 10 * max(w0, h0) * iter_scale)
        if iter_max > 0:
            iters = min(iters, iter_max)
        u_l, v_l, _, _, trace = irls_level_fast(
            u0, v0, gx, gy, it_l, float(sigma_d), float(sigma_s),
            iters, param.error_min_threshold, level == 0,
            fuse, sup_mode)
        _emit_energy_trace_fast(level, trace, 64 if level == 0 else fuse,
                                energy_trace)
        if level < max_level:
            u_l, v_l = add_vector_offset(u_l, v_l, u, v)
        u, v = u_l, v_l
    return u, v


def _emit_energy_trace_fast(level: int, trace, check_every: int,
                            energy_trace=None) -> None:
    from tpuflow.utils.telemetry import EnergyTrace, get_telemetry

    if energy_trace is None and not get_telemetry().enabled:
        return
    if energy_trace is None:
        energy_trace = EnergyTrace()
    import numpy as np

    for k, e in enumerate(np.asarray(trace)):
        if np.isnan(e):
            break
        energy_trace.record(level, (k + 1) * check_every, float(e))
