"""Distributed (multi-chip) flow solvers: 2-D image tiling + halo exchange.

The scaling axis of the reference is image-domain size (SURVEY.md §5.7);
here 4K+ frames are tiled over a ("ty", "tx") device mesh. Two mechanisms:

- *auto*: ``jit`` with NamedSharding-annotated inputs — XLA GSPMD
  partitions the convolutions/stencils and inserts halo exchanges itself.
  Used for one-shot ops (gradients, pyramid levels).
- *explicit*: ``shard_map`` bodies with :func:`tpuflow.dist.halo.halo_pad_2d`
  ppermute exchanges — used for the relaxation loops so the whole
  iterate-exchange cycle stays in one compiled program, and as the basis
  for k-sweeps-per-exchange fusion.

Equivalence: Jacobi sweeps are tile-invariant given fresh 1-px halos each
iteration, and zero-filled global-border halos match the reference's
BORDER_CONSTANT/zeropad convention, so the distributed solve matches the
single-device solve to float associativity (verified in
tests/test_dist.py; SURVEY.md §2.6).

Compiled-program caching: every ``shard_map`` body is built inside an
``lru_cache``-ed factory keyed on the static parameters (mesh included —
it hashes). Building ``jax.jit(shard_map(...))`` per call would create a
fresh jit cache each time and recompile every invocation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuflow.dist.halo import halo_pad_2d
from tpuflow.ops.stencil import hs_sweeps, inside_mask, irls_sweeps, nb_masks
from tpuflow.solvers.horn_schunck import hs_gradients
from tpuflow.solvers.mestimators import geman_mcclure_psi, geman_mcclure_rho

_hs_gradients_jit = jax.jit(hs_gradients)

SPEC = P("ty", "tx")


def shard_map(f, mesh, in_specs, out_specs):
    # check_vma=False: tile bodies start loop carries from replicated
    # constants (zeros) that become device-varying inside the loop.
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _box_valid(padded: jnp.ndarray, size: int) -> jnp.ndarray:
    """Separable box *mean*, VALID region, as shifted adds."""
    h, w = padded.shape
    rows = padded[0 : h - size + 1, :]
    for d in range(1, size):
        rows = rows + padded[d : h - size + 1 + d, :]
    out = rows[:, 0 : w - size + 1]
    for d in range(1, size):
        out = out + rows[:, d : w - size + 1 + d]
    return out * (1.0 / (size * size))


@functools.lru_cache(maxsize=64)
def _hs_sharded_fn(mesh: Mesh, window_size: int, max_iterations: int,
                   alpha: float):
    r = window_size // 2

    def tile_body(gx_t, gy_t, gt_t):
        denom = alpha * alpha + gx_t * gx_t + gy_t * gy_t
        u0 = jnp.zeros_like(gt_t)
        v0 = jnp.zeros_like(gt_t)

        def body(_, uv):
            u, v = uv
            up = halo_pad_2d(u, r)
            vp = halo_pad_2d(v, r)
            ubar = _box_valid(up, window_size)
            vbar = _box_valid(vp, window_size)
            upd = (gx_t * ubar + gy_t * vbar + gt_t) / denom
            return ubar - gx_t * upd, vbar - gy_t * upd

        return lax.fori_loop(0, max_iterations, body, (u0, v0))

    return jax.jit(shard_map(tile_body, mesh, in_specs=(SPEC,) * 3,
                             out_specs=(SPEC, SPEC)))


def horn_schunck_sharded(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    mesh: Mesh,
    window_size: int = 5,
    max_iterations: int = 100,
    alpha: float = 1.0,
):
    """Distributed box-Jacobi Horn-Schunck over a ("ty", "tx") mesh.

    H and W must be divisible by the mesh extents. Returns (u, v) sharded
    over the mesh.
    """
    h, w = prev.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    sharding = NamedSharding(mesh, SPEC)
    prev = jax.device_put(prev, sharding)
    next = jax.device_put(next, sharding)

    # Gradients: auto-sharded (XLA handles the reflect101 halo).
    gx, gy, gt = _hs_gradients_jit(prev, next)
    f = _hs_sharded_fn(mesh, int(window_size), int(max_iterations),
                       float(alpha))
    return f(gx, gy, gt)


@functools.lru_cache(maxsize=64)
def _hs_sharded_fused_fn(mesh: Mesh, h: int, w: int, window_size: int,
                         max_iterations: int, alpha: float, fuse: int):
    r = window_size // 2
    n_blocks, rem = divmod(max_iterations, fuse)

    def tile_body(gx_t, gy_t, gt_t):
        th, tw = gx_t.shape
        inv_denom = 1.0 / (alpha * alpha + gx_t * gx_t + gy_t * gy_t)
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")

        def run_block(u, v, k):
            hk = k * r
            u_p = halo_pad_2d(u, hk)
            v_p = halo_pad_2d(v, hk)
            gx_p = halo_pad_2d(gx_t, hk)
            gy_p = halo_pad_2d(gy_t, hk)
            gt_p = halo_pad_2d(gt_t, hk)
            inv_p = halo_pad_2d(inv_denom, hk)
            mask = inside_mask(iy * th - hk, ix * tw - hk, th + 2 * hk,
                               tw + 2 * hk, h, w, u.dtype)
            return hs_sweeps(u_p * mask, v_p * mask, gx_p, gy_p, gt_p,
                             inv_p, mask, window_size, k)

        u = jnp.zeros_like(gt_t)
        v = jnp.zeros_like(gt_t)
        if n_blocks:
            u, v = lax.fori_loop(
                0, n_blocks, lambda _, uv: run_block(*uv, fuse), (u, v))
        if rem:
            u, v = run_block(u, v, rem)
        return u, v

    return jax.jit(shard_map(tile_body, mesh, in_specs=(SPEC,) * 3,
                             out_specs=(SPEC, SPEC)))


def horn_schunck_sharded_fused(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    mesh: Mesh,
    window_size: int = 5,
    max_iterations: int = 100,
    alpha: float = 1.0,
    fuse: int = 5,
):
    """Horn-Schunck with k sweeps per halo exchange.

    Exchanges a (fuse * r)-wide halo once per block of ``fuse``
    iterations (ppermute) and runs the sweeps on statically shrinking
    regions (:func:`tpuflow.ops.stencil.hs_sweeps`). Bitwise-equivalent
    Jacobi: an inside-image mask from global tile
    coordinates re-zeroes u, v outside the frame after every sweep,
    preserving BORDER_CONSTANT semantics through the halo zone.
    """
    h, w = prev.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    sharding = NamedSharding(mesh, SPEC)
    prev = jax.device_put(prev, sharding)
    next = jax.device_put(next, sharding)
    r = window_size // 2
    halo = fuse * r
    if h // ty <= halo or w // tx <= halo:
        raise ValueError("tile smaller than the fused halo; lower fuse")

    gx, gy, gt = _hs_gradients_jit(prev, next)
    f = _hs_sharded_fused_fn(mesh, h, w, int(window_size),
                             int(max_iterations), float(alpha), int(fuse))
    return f(gx, gy, gt)


@functools.lru_cache(maxsize=16)
def _hs_sharded_fused_dyn_fn(mesh: Mesh, h: int, w: int, window_size: int,
                             alpha: float, fuse: int):
    """:func:`_hs_sharded_fused_fn` with the BLOCK COUNT as a runtime
    operand: one compiled program serves every iteration budget that is
    a multiple of ``fuse``, so the weak-scaling harness's two-point
    timing (tpuflow/dist/scaling.py) needs one compile, not two."""
    r = window_size // 2

    def tile_body(n_blocks, gx_t, gy_t, gt_t):
        th, tw = gx_t.shape
        inv_denom = 1.0 / (alpha * alpha + gx_t * gx_t + gy_t * gy_t)
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")

        def run_block(u, v):
            hk = fuse * r
            u_p = halo_pad_2d(u, hk)
            v_p = halo_pad_2d(v, hk)
            gx_p = halo_pad_2d(gx_t, hk)
            gy_p = halo_pad_2d(gy_t, hk)
            gt_p = halo_pad_2d(gt_t, hk)
            inv_p = halo_pad_2d(inv_denom, hk)
            mask = inside_mask(iy * th - hk, ix * tw - hk, th + 2 * hk,
                               tw + 2 * hk, h, w, u.dtype)
            return hs_sweeps(u_p * mask, v_p * mask, gx_p, gy_p, gt_p,
                             inv_p, mask, window_size, fuse)

        u = jnp.zeros_like(gt_t)
        v = jnp.zeros_like(gt_t)
        u, v, _ = lax.while_loop(
            lambda c: c[2] < n_blocks,
            lambda c: (*run_block(c[0], c[1]), c[2] + 1),
            (u, v, jnp.int32(0)))
        return u, v

    return jax.jit(shard_map(tile_body, mesh,
                             in_specs=(P(), SPEC, SPEC, SPEC),
                             out_specs=(SPEC, SPEC)))


def horn_schunck_sharded_fused_dynamic(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    mesh: Mesh,
    window_size: int = 5,
    max_iterations: int = 100,
    alpha: float = 1.0,
    fuse: int = 5,
):
    """:func:`horn_schunck_sharded_fused` with a runtime iteration count
    (must be a multiple of ``fuse``); same result, one compile for all
    budgets."""
    h, w = prev.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    if max_iterations % fuse:
        raise ValueError("max_iterations must be a multiple of fuse")
    sharding = NamedSharding(mesh, SPEC)
    prev = jax.device_put(prev, sharding)
    next = jax.device_put(next, sharding)
    r = window_size // 2
    if h // ty <= fuse * r or w // tx <= fuse * r:
        raise ValueError("tile smaller than the fused halo; lower fuse")
    gx, gy, gt = _hs_gradients_jit(prev, next)
    f = _hs_sharded_fused_dyn_fn(mesh, h, w, int(window_size),
                                 float(alpha), int(fuse))
    return f(jnp.int32(max_iterations // fuse), gx, gy, gt)


# ---------------------------------------------------------------------------
# Distributed Black-Anandan IRLS level


def _neighbor_terms(u_p, v_p, u, v, sigma_s, mask_l, mask_r, mask_t, mask_b,
                    fn):
    """Sum fn(u - u_nbr) over the 4 neighbors of each interior site.

    u_p/v_p are 1-px halo-padded tiles; masks kill contributions at the
    *global* image border (Error_u skips missing neighbors,
    OpticalFlow.cpp:288-304).
    """
    h, w = u.shape
    sl = lambda a, dy, dx: lax.dynamic_slice(a, (1 + dy, 1 + dx), (h, w))
    nx = (jnp.where(mask_l, fn(u - sl(u_p, 0, -1), sigma_s), 0.0)
          + jnp.where(mask_r, fn(u - sl(u_p, 0, 1), sigma_s), 0.0)
          + jnp.where(mask_t, fn(u - sl(u_p, -1, 0), sigma_s), 0.0)
          + jnp.where(mask_b, fn(u - sl(u_p, 1, 0), sigma_s), 0.0))
    ny = (jnp.where(mask_l, fn(v - sl(v_p, 0, -1), sigma_s), 0.0)
          + jnp.where(mask_r, fn(v - sl(v_p, 0, 1), sigma_s), 0.0)
          + jnp.where(mask_t, fn(v - sl(v_p, -1, 0), sigma_s), 0.0)
          + jnp.where(mask_b, fn(v - sl(v_p, 1, 0), sigma_s), 0.0))
    return nx, ny




def _sup_sharded(g_t, lambda_d: float, lambda_s: float, sigma_d: float,
                 sigma_s: float, sup_mode: str):
    """Distributed sup_Error_uu: pmax over the mesh, then the same
    bound as tpuflow.solvers.black_anandan.irls_sup (``"reference"``
    keeps the reference's over-conservative /sigma^2 form bit-parity;
    ``"analytic"`` takes the true Geman-McClure curvature bound 2/sigma
    — same minimizer, ~20x the descent rate)."""
    gmax = lax.pmax(lax.pmax(jnp.max(g_t * g_t), "tx"), "ty")
    if sup_mode == "analytic":
        return (lambda_d * gmax * (2.0 / sigma_d)
                + 4.0 * lambda_s * (2.0 / sigma_s))
    if sup_mode != "reference":
        raise ValueError(f"unknown sup_mode {sup_mode!r}")
    return lambda_d * gmax / sigma_d**2 + 4.0 * lambda_s / sigma_s**2

@functools.lru_cache(maxsize=64)
def _irls_sharded_fn(mesh: Mesh, h: int, w: int, lambda_d: float,
                     lambda_s: float, sigma_d: float, sigma_s: float,
                     iter_max: int, error_min_threshold: float,
                     is_level0: bool, energy_every: int,
                     sup_mode: str = "reference"):
    def tile_body(u0_t, v0_t, gx_t, gy_t, it_t):
        th, tw = gx_t.shape
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")
        xg = ix * tw + jnp.arange(tw)[None, :]
        yg = iy * th + jnp.arange(th)[:, None]
        mask_l = jnp.broadcast_to(xg > 0, (th, tw))
        mask_r = jnp.broadcast_to(xg < w - 1, (th, tw))
        mask_t = jnp.broadcast_to(yg > 0, (th, tw))
        mask_b = jnp.broadcast_to(yg < h - 1, (th, tw))

        sup_x = _sup_sharded(gx_t, lambda_d, lambda_s, sigma_d, sigma_s,
                             sup_mode)
        sup_y = _sup_sharded(gy_t, lambda_d, lambda_s, sigma_d, sigma_s,
                             sup_mode)

        def energy(u, v):
            u_p = halo_pad_2d(u, 1)
            v_p = halo_pad_2d(v, 1)
            nx, ny = _neighbor_terms(u_p, v_p, u, v, sigma_s,
                                     mask_l, mask_r, mask_t, mask_b,
                                     geman_mcclure_rho)
            center = geman_mcclure_rho(gx_t * u + gy_t * v + it_t, sigma_d)
            local = jnp.sum(lambda_d * center + lambda_s * (nx + ny))
            return lax.psum(lax.psum(local, "tx"), "ty")

        def cond(carry):
            u, v, E, inc, n, stop = carry
            return jnp.logical_and(n < iter_max, jnp.logical_not(stop))

        def body(carry):
            u, v, E, inc, n, _ = carry
            u_p = halo_pad_2d(u, 1)
            v_p = halo_pad_2d(v, 1)
            nx, ny = _neighbor_terms(u_p, v_p, u, v, sigma_s,
                                     mask_l, mask_r, mask_t, mask_b,
                                     geman_mcclure_psi)
            center = geman_mcclure_psi(gx_t * u + gy_t * v + it_t, sigma_d)
            dEx = lambda_d * gx_t * center + lambda_s * nx
            dEy = lambda_d * gy_t * center + lambda_s * ny
            u = u - dEx / sup_x
            v = v - dEy / sup_y
            if is_level0:
                E_new = lax.cond((n % energy_every) == 0,
                                 lambda: energy(u, v), lambda: E)
                inc_new = inc
            else:
                E_new = energy(u, v)
                inc_new = jnp.where(E_new > E, inc + 1, 0)
            stop = jnp.logical_or(E_new < error_min_threshold, inc_new > 3)
            return u, v, E_new, inc_new, n + 1, stop

        E0 = jnp.asarray(0.0, u0_t.dtype)
        u, v, E, _, n, _ = lax.while_loop(
            cond, body,
            (u0_t, v0_t, E0, jnp.int32(0), jnp.int32(0), jnp.bool_(False)))
        return u, v

    return jax.jit(shard_map(tile_body, mesh, in_specs=(SPEC,) * 5,
                             out_specs=(SPEC, SPEC)))


def irls_level_sharded(
    u0, v0, gx, gy, it, mesh: Mesh,
    lambda_d: float, lambda_s: float, sigma_d: float, sigma_s: float,
    iter_max: int, error_min_threshold: float, is_level0: bool,
    energy_every: int = 64,
    sup_mode: str = "reference",
):
    """Distributed IRLS relaxation level, semantics of
    IRLS_OpticalFlow_Pyramid (OpticalFlow.cpp:213-270) over the mesh.

    sup uses pmax, the energy uses psum; all devices follow the same
    stopping decision.
    """
    h, w = gx.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    sharding = NamedSharding(mesh, SPEC)
    args = [jax.device_put(a, sharding) for a in (u0, v0, gx, gy, it)]
    f = _irls_sharded_fn(mesh, h, w, float(lambda_d), float(lambda_s),
                         float(sigma_d), float(sigma_s), int(iter_max),
                         float(error_min_threshold), bool(is_level0),
                         int(energy_every), sup_mode)
    return f(*args)


@functools.lru_cache(maxsize=64)
def _irls_sharded_fused_fn(mesh: Mesh, h: int, w: int, lambda_d: float,
                           lambda_s: float, sigma_d: float, sigma_s: float,
                           iter_max: int, error_min_threshold: float,
                           is_level0: bool, fuse: int,
                           sup_mode: str = "reference"):
    check_every = 64 if is_level0 else fuse
    blocks_per_check = max(check_every // fuse, 1)
    n_blocks = -(-iter_max // fuse)

    def tile_body(u0_t, v0_t, gx_t, gy_t, it_t):
        th, tw = gx_t.shape
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")
        xg = ix * tw + jnp.arange(tw)[None, :]
        yg = iy * th + jnp.arange(th)[:, None]
        mask_l = jnp.broadcast_to(xg > 0, (th, tw))
        mask_r = jnp.broadcast_to(xg < w - 1, (th, tw))
        mask_t = jnp.broadcast_to(yg > 0, (th, tw))
        mask_b = jnp.broadcast_to(yg < h - 1, (th, tw))

        sup_x = _sup_sharded(gx_t, lambda_d, lambda_s, sigma_d, sigma_s,
                             sup_mode)
        sup_y = _sup_sharded(gy_t, lambda_d, lambda_s, sigma_d, sigma_s,
                             sup_mode)

        def energy(u, v):
            u_p = halo_pad_2d(u, 1)
            v_p = halo_pad_2d(v, 1)
            nx, ny = _neighbor_terms(u_p, v_p, u, v, sigma_s,
                                     mask_l, mask_r, mask_t, mask_b,
                                     geman_mcclure_rho)
            center = geman_mcclure_rho(gx_t * u + gy_t * v + it_t, sigma_d)
            local = jnp.sum(lambda_d * center + lambda_s * (nx + ny))
            return lax.psum(lax.psum(local, "tx"), "ty")

        def sweep_block(u, v):
            u_p = halo_pad_2d(u, fuse)
            v_p = halo_pad_2d(v, fuse)
            gx_p = halo_pad_2d(gx_t, fuse)
            gy_p = halo_pad_2d(gy_t, fuse)
            it_p = halo_pad_2d(it_t, fuse)
            nb = nb_masks(iy * th - fuse, ix * tw - fuse, th + 2 * fuse,
                          tw + 2 * fuse, h, w, u.dtype)
            return irls_sweeps(u_p, v_p, gx_p, gy_p, it_p, nb,
                               sup_x, sup_y, fuse,
                               lambda_d, lambda_s, sigma_d, sigma_s)

        def cond(carry):
            u, v, E, inc, b, stop = carry
            return jnp.logical_and(b < n_blocks, jnp.logical_not(stop))

        def body(carry):
            u, v, E, inc, b, _ = carry
            u, v = sweep_block(u, v)
            do_check = (b % blocks_per_check) == (blocks_per_check - 1)

            def check(args):
                u, v, E, inc = args
                E_new = energy(u, v)
                inc_new = jnp.where(E_new > E, inc + 1, 0) \
                    if not is_level0 else inc
                return E_new, inc_new

            E_new, inc_new = lax.cond(
                do_check, check, lambda args: (args[2], args[3]),
                (u, v, E, inc))
            stop = jnp.logical_and(
                do_check,
                jnp.logical_or(E_new < error_min_threshold, inc_new > 3))
            return u, v, E_new, inc_new, b + 1, stop

        E0 = jnp.asarray(0.0, u0_t.dtype)
        u, v, E, _, b, _ = lax.while_loop(
            cond, body, (u0_t, v0_t, E0, jnp.int32(0), jnp.int32(0),
                         jnp.bool_(False)))
        return u, v

    return jax.jit(shard_map(tile_body, mesh, in_specs=(SPEC,) * 5,
                             out_specs=(SPEC, SPEC)))


def irls_level_sharded_fused(
    u0, v0, gx, gy, it, mesh: Mesh,
    lambda_d: float, lambda_s: float, sigma_d: float, sigma_s: float,
    iter_max: int, error_min_threshold: float, is_level0: bool,
    fuse: int = 16,
    sup_mode: str = "reference",
):
    """Distributed IRLS level with ``fuse`` sweeps per halo exchange —
    the multi-device analogue of
    :func:`tpuflow.solvers.black_anandan_fast.irls_level_fast`.

    Each block exchanges a ``fuse``-wide halo once (ppermute) and runs
    ``fuse`` Jacobi sweeps on statically shrinking regions — the same
    body as the single-device path
    (:func:`tpuflow.ops.stencil.irls_sweeps`). The energy stop test (psum) runs
    between blocks at the fast-path cadence: every 64 iterations at
    level 0 (the reference's exact cadence, OpticalFlow.cpp:248), every
    ``fuse`` above (coarser early-stop, identical descent). ppermute
    latency count drops by ``fuse`` vs :func:`irls_level_sharded`.
    """
    h, w = gx.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    if h // ty <= fuse or w // tx <= fuse:
        raise ValueError("tile smaller than the fused halo; lower fuse")
    sharding = NamedSharding(mesh, SPEC)
    args = [jax.device_put(a, sharding) for a in (u0, v0, gx, gy, it)]
    f = _irls_sharded_fused_fn(mesh, h, w, float(lambda_d), float(lambda_s),
                               float(sigma_d), float(sigma_s), int(iter_max),
                               float(error_min_threshold), bool(is_level0),
                               int(fuse), sup_mode)
    return f(*args)
