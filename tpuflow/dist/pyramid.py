"""Distributed coarse-to-fine Black-Anandan flow.

Strategy (SURVEY.md §7.3 "LevelDown warp gather"): coarse pyramid levels
are tiny — replicating them costs nothing and sidesteps displacement-
bounded halo analysis; only the finest level(s) carry real memory and
compute. So:

- pyramids, derivatives and the LevelDown warp run under plain ``jit``
  with NamedSharding-annotated finest-level inputs — XLA GSPMD partitions
  the convolutions/gathers and inserts the halo collectives itself;
- each level's IRLS relaxation runs in ``shard_map``
  (:func:`tpuflow.dist.solvers.irls_level_sharded`) when the level is
  divisible over the mesh, else on replicated data (identical math —
  Jacobi is tile-invariant, so the mixed schedule matches the
  single-device solve to float associativity);
- the iteration budget/annealing/stopping mirror
  :func:`tpuflow.solvers.black_anandan.optical_flow_pyramid`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuflow.core.config import MultipleMotionParam
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
    irls_optical_flow_level,
)
from tpuflow.dist.solvers import irls_level_sharded, irls_level_sharded_fused


def optical_flow_pyramid_sharded(
    it_img: jnp.ndarray,
    itp1_img: jnp.ndarray,
    mesh: Mesh,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    iter_scale: float = 1.0,
    iter_max: int = -1,
    fuse: int = 0,
    sup_mode: str = "reference",
):
    """Multi-chip Black-Anandan coarse-to-fine flow. Returns (u, v)
    sharded over the ("ty", "tx") mesh at full resolution.

    ``fuse > 0`` selects the production path: ``fuse`` sweeps per halo
    exchange (:func:`tpuflow.dist.solvers.irls_level_sharded_fused`) on every
    level whose tiles fit the fused halo — identical descent, early-stop
    checks at the :func:`tpuflow.solvers.black_anandan_fast` cadence.
    ``fuse = 0`` exchanges a 1-px halo every iteration (the reference's
    exact stopping semantics on every level). ``sup_mode="analytic"``
    takes the true Geman-McClure Lipschitz bound (~20x the descent
    rate, same minimizer — tpuflow.solvers.black_anandan.irls_sup)."""
    if param is None:
        param = MultipleMotionParam()
    ty, tx = mesh.devices.shape
    spec = P("ty", "tx")
    sharding = NamedSharding(mesh, spec)

    it_n = jax.device_put(it_img / max_int, sharding)
    itp1_n = jax.device_put(itp1_img / max_int, sharding)

    max_level = param.level
    # Pyramid build auto-sharded; coarse levels effectively replicate.
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
        h, w = it_l.shape
        iters = int((level + 1) * 10 * max(w0, h0) * iter_scale)
        if iter_max > 0:
            iters = min(iters, iter_max)
        z = jnp.zeros_like(it_l)
        if (fuse > 0 and h % ty == 0 and w % tx == 0
                and h // ty > fuse and w // tx > fuse):
            u_l, v_l = irls_level_sharded_fused(
                z, z, gx, gy, it_l, mesh, LAMBDA_D, LAMBDA_S,
                sigma_d, sigma_s, iters, param.error_min_threshold,
                level == 0, fuse=fuse,
                sup_mode=sup_mode)
        elif h % ty == 0 and w % tx == 0 and h // ty >= 2 and w // tx >= 2:
            u_l, v_l = irls_level_sharded(
                z, z, gx, gy, it_l, mesh, LAMBDA_D, LAMBDA_S,
                sigma_d, sigma_s, iters, param.error_min_threshold,
                level == 0, sup_mode=sup_mode)
        else:
            # Tiny level: replicate (single-program, all devices identical).
            u_l, v_l, _, _, _ = irls_optical_flow_level(
                z, z, gx, gy, it_l, LAMBDA_D, LAMBDA_S, sigma_d, sigma_s,
                iters, param.error_min_threshold, level == 0, sup_mode)
        if level < max_level:
            u_l, v_l = add_vector_offset(u_l, v_l, u, v)
        u, v = u_l, v_l
    return u, v
