"""Distributed region-gated IRLS refinement — the flagship BM path's
OpticalFlow_GradientMethod over a device mesh.

Multi-chip analogue of :func:`tpuflow.solvers.bm_flow.gradient_method_flow`
(OpticalFlow_BlockMatching.cpp:367-462, the ``#pragma omp parallel for``
site loop at :433-441 as SURVEY.md §2.6's shard_map/ppermute scheme):

- gradients + dt are computed inside the shard_map from 1-px ppermute
  halos, with the single-chip mirror-border values re-selected at the
  global image edge (bitwise the op order of ``gradient_method_grad`` /
  ``gradient_method_dt_zero`` — the flagship zeroes MV before this
  refine, so the dt needs no warp gather);
- the IRLS loop exchanges a ``fuse``-wide halo once per block of
  ``fuse`` region-gated Jacobi sweeps
  (:func:`tpuflow.ops.stencil.irls_sweeps_gated`) — label halos carry REAL
  neighbor-tile labels, so the region gate is exact across tile
  boundaries;
- sup uses pmax, the 64-iteration energy cadence + 3-strikes divergence
  stop use psum (every device takes the same stopping decision), and the
  E(n) trace comes back at the reference cadence
  (OpticalFlow.cpp:261-265).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding

from tpuflow.core.color import LAB_SCALE
from tpuflow.dist.halo import halo_pad_2d
from tpuflow.dist.solvers import SPEC, shard_map
from tpuflow.ops.stencil import irls_sweeps_gated, nb_masks
from tpuflow.solvers.mestimators import geman_mcclure_psi, geman_mcclure_rho


def _fwd_mirror(tile_p, dx: int, dy: int, at_xedge, at_yedge, th: int,
                tw: int):
    """Value of img.get_mirror(x + dx, y + dy) for dx, dy in {0, 1} on a
    1-px halo-padded tile: the +1 neighbor from the halo, re-selected to
    the -1 neighbor at the global far edge (mirror: 2w-2-(w) = w-2)."""

    def sl(ddy, ddx):
        return lax.dynamic_slice(tile_p, (1 + ddy, 1 + ddx), (th, tw))

    if dx and dy:
        a = jnp.where(at_xedge, sl(1, -1), sl(1, 1))
        b = jnp.where(at_xedge, sl(-1, -1), sl(-1, 1))
        return jnp.where(at_yedge, b, a)
    if dx:
        return jnp.where(at_xedge, sl(0, -1), sl(0, 1))
    if dy:
        return jnp.where(at_yedge, sl(-1, 0), sl(1, 0))
    return sl(0, 0)


def _grad_tile(int_t, at_xedge, at_yedge):
    """gx, gy (2x2 forward diff of the interest tile) plus the four
    interest taps — bitwise the op order of gradient_method_grad
    (OpticalFlow_BlockMatching.cpp:372-384)."""
    th, tw = int_t.shape
    int_p = halo_pad_2d(int_t, 1)

    def at(ddx, ddy):
        return _fwd_mirror(int_p, ddx, ddy, at_xedge, at_yedge, th, tw)

    i00 = at(0, 0)
    i10 = at(1, 0)
    i01 = at(0, 1)
    i11 = at(1, 1)
    gx = ((i10 - i00) + (i11 - i01)) / 2.0
    gy = ((i01 - i00) + (i11 - i10)) / 2.0
    return gx, gy, (i00, i10, i01, i11)


def _dt_zero_tile(ref_t, int_taps, at_xedge, at_yedge):
    """Zero-warp dt against the shared interest taps — bitwise the op
    order of gradient_method_dt_zero
    (OpticalFlow_BlockMatching.cpp:385-397 with MV == 0)."""
    th, tw = ref_t.shape
    i00, i10, i01, i11 = int_taps
    ref_p = halo_pad_2d(ref_t, 1)

    def at(ddx, ddy):
        return _fwd_mirror(ref_p, ddx, ddy, at_xedge, at_yedge, th, tw)

    return (at(0, 0) - i00 + at(1, 0) - i10
            + at(0, 1) - i01 + at(1, 1) - i11) / 4.0


def _grad_dt_tile(int_t, ref_t, at_xedge, at_yedge):
    """gx, gy and the zero-warp dt for one reference tile."""
    gx, gy, taps = _grad_tile(int_t, at_xedge, at_yedge)
    return gx, gy, _dt_zero_tile(ref_t, taps, at_xedge, at_yedge)


def _gated_energy_tile(u, v, lab_t, gx, gy, it, masks,
                       lambda_d: float, lambda_s: float,
                       sigma_d: float, sigma_s: float):
    """Local term of Error_MultipleMotion_Block
    (OpticalFlow_BlockMatching.cpp:540-590) on a tile: 1-px ppermute
    halos, same per-site op order as
    tpuflow.solvers.bm_flow._neighbor_energy; the caller psums."""
    th, tw = u.shape
    dt = u.dtype
    u_p = halo_pad_2d(u, 1)
    v_p = halo_pad_2d(v, 1)
    lab_p = halo_pad_2d(lab_t, 1)
    norm_c = jnp.sqrt(u * u + v * v)
    E = jnp.zeros_like(u)

    def sl(a, dy, dx):
        return lax.dynamic_slice(a, (1 + dy, 1 + dx), (th, tw))

    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        un = sl(u_p, dy, dx)
        vn = sl(v_p, dy, dx)
        ln = sl(lab_p, dy, dx)
        gate = masks[(dx, dy)] * (ln == lab_t).astype(dt)
        nn = jnp.sqrt(un * un + vn * vn)
        prod = norm_c * nn
        cosang = jnp.where(prod > 0,
                           (u * un + v * vn) / jnp.maximum(prod, 1e-30),
                           1.0)
        m = gate * (0.5 * (1.0 + cosang))
        E = E + m * (geman_mcclure_rho(u - un, sigma_s)
                     + geman_mcclure_rho(v - vn, sigma_s))
    center = geman_mcclure_rho(gx * u + gy * v + it, sigma_d)
    return jnp.sum(lambda_d * center + lambda_s * E)


@functools.lru_cache(maxsize=64)
def _gated_sharded_fn(mesh: Mesh, h: int, w: int, lambda_d: float,
                      lambda_s: float, sigma_d: float, sigma_s: float,
                      iter_max: int, error_min_threshold: float,
                      fuse: int, external_dt: bool = False,
                      sup_mode: str = "reference",
                      plateau_rtol: float = 0.0):
    blocks_per_check = max(64 // fuse, 1)
    n_blocks = -(-iter_max // fuse)
    n_checks = max(-(-n_blocks // blocks_per_check), 1)

    def tile_body(int_t, ref_t, lab_t):
        th, tw = int_t.shape
        dt = int_t.dtype
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")
        xg = ix * tw + jnp.arange(tw)[None, :]
        yg = iy * th + jnp.arange(th)[:, None]
        at_xedge = jnp.broadcast_to(xg == w - 1, (th, tw))
        at_yedge = jnp.broadcast_to(yg == h - 1, (th, tw))

        if external_dt:
            # refine_warp: ref_t carries the PRE-COMPUTED
            # dt-under-BM-warp tile (the floor(MV) gather crosses tiles
            # by up to the search bound, so it is evaluated outside the
            # shard_map — gradient_method_dt on the full frames — and
            # passed in sharded).
            gx, gy, _ = _grad_tile(int_t, at_xedge, at_yedge)
            it = ref_t
        else:
            gx, gy, it = _grad_dt_tile(int_t, ref_t, at_xedge, at_yedge)

        gx2 = lax.pmax(lax.pmax(jnp.max(gx * gx), "tx"), "ty")
        gy2 = lax.pmax(lax.pmax(jnp.max(gy * gy), "tx"), "ty")
        if sup_mode == "analytic":
            # True Geman-McClure curvature bound (bm_flow._gated_sup).
            sup_x = (lambda_d * gx2 * (2.0 / sigma_d)
                     + 4.0 * lambda_s * (2.0 / sigma_s))
            sup_y = (lambda_d * gy2 * (2.0 / sigma_d)
                     + 4.0 * lambda_s * (2.0 / sigma_s))
        else:
            sup_x = (lambda_d * gx2 / sigma_d**2
                     + 4.0 * lambda_s / sigma_s**2)
            sup_y = (lambda_d * gy2 / sigma_d**2
                     + 4.0 * lambda_s / sigma_s**2)

        row0 = iy * th - fuse
        col0 = ix * tw - fuse
        nb = nb_masks(row0, col0, th + 2 * fuse, tw + 2 * fuse, h, w, dt)
        # Static across sweeps: exchange the field/label halos once.
        gx_p = halo_pad_2d(gx, fuse)
        gy_p = halo_pad_2d(gy, fuse)
        it_p = halo_pad_2d(it, fuse)
        lab_p = halo_pad_2d(lab_t, fuse)

        # 1-px masks for the energy's neighbor gating (global border).
        e_masks = {}
        for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ok = ((yg + dy >= 0) & (yg + dy < h)
                  & (xg + dx >= 0) & (xg + dx < w))
            e_masks[(dx, dy)] = jnp.broadcast_to(ok, (th, tw)).astype(dt)

        def energy(u, v):
            local = _gated_energy_tile(u, v, lab_t, gx, gy, it, e_masks,
                                       lambda_d, lambda_s, sigma_d,
                                       sigma_s)
            return lax.psum(lax.psum(local, "tx"), "ty")

        def sweep_block(u, v):
            return irls_sweeps_gated(
                halo_pad_2d(u, fuse), halo_pad_2d(v, fuse),
                gx_p, gy_p, it_p, lab_p, nb, sup_x, sup_y, fuse,
                lambda_d, lambda_s, sigma_d, sigma_s)

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
                return E_new, jnp.where(E_new > E, inc + 1, 0)

            E_new, inc_new = lax.cond(
                do_check, check, lambda args: (args[2], args[3]),
                (u, v, E, inc))
            trace = lax.cond(
                do_check,
                lambda: trace.at[b // blocks_per_check].set(E_new),
                lambda: trace)
            should_stop = jnp.logical_or(E_new < error_min_threshold,
                                         inc_new > 3)
            if plateau_rtol > 0.0:
                # E carries the previous check's energy (0 before the
                # first check) — bm_flow.irls_gradient_method's
                # plateau-stop contract at the fused-block cadence.
                should_stop = jnp.logical_or(
                    should_stop,
                    jnp.logical_and(
                        E > 0, E_new >= (1.0 - plateau_rtol) * E))
            stop = jnp.logical_and(do_check, should_stop)
            return u, v, E_new, inc_new, b + 1, stop, trace

        E0 = jnp.asarray(0.0, dt)
        trace0 = jnp.full((n_checks,), jnp.nan, dt)
        u, v, E, _, b, _, trace = lax.while_loop(
            cond, body,
            (jnp.zeros_like(gx), jnp.zeros_like(gx), E0, jnp.int32(0),
             jnp.int32(0), jnp.bool_(False), trace0))
        return u, v, trace

    return jax.jit(shard_map(
        tile_body, mesh, in_specs=(SPEC, SPEC, SPEC),
        out_specs=(SPEC, SPEC, jax.sharding.PartitionSpec())))


def gradient_method_flow_sharded(
    reference_lab,
    interest_lab,
    labels,
    mesh: Mesh,
    lambda_d: float = 5.0,
    lambda_s: float = 1.0,
    sigma_d: float = 0.2 / np.sqrt(2.0),
    sigma_s: float = 0.03 / np.sqrt(2.0),
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    fuse: int = 8,
    mv=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
):
    """Distributed OpticalFlow_GradientMethod: returns (u, v, trace).

    Same descent as :func:`tpuflow.solvers.bm_flow.gradient_method_flow`
    with ``zero_warp=True`` (the flagship's reproduced MV-zeroing); the
    early-stop decision points sit at the fused-block cadence (64, 128,
    ... iterations — the fast-kernel contract of
    ``irls_gradient_method_fast``). ``labels`` may be any int map; it is
    carried as float for the tile-edge-exact region gate.

    ``mv`` (an (H, W, 2) per-pixel BM field) switches the dt to the
    non-debug BM warp (the driver's ``refine_warp=True``): the floor(MV)
    gather crosses tile borders by up to the search bound, so the dt is
    computed once on the full frames (gradient_method_dt, replicated —
    cheap at image scale) and fed into the shard_map sharded.
    """
    h, w = labels.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    if h // ty <= fuse or w // tx <= fuse:
        raise ValueError("tile smaller than the fused halo; lower fuse")
    # Standard Lab units — matches the single-device
    # gradient_method_flow (core/color.py LAB_SCALE).
    interest_l = jnp.asarray(interest_lab)[..., 0] * LAB_SCALE
    reference_l = jnp.asarray(reference_lab)[..., 0] * LAB_SCALE
    if mv is not None:
        from tpuflow.solvers.bm_flow import gradient_method_dt

        second = gradient_method_dt(reference_l, interest_l,
                                    mv[..., 0], mv[..., 1])
    else:
        second = reference_l
    dt = interest_l.dtype
    sharding = NamedSharding(mesh, SPEC)
    args = [jax.device_put(a, sharding)
            for a in (interest_l, second,
                      jnp.asarray(labels).astype(dt))]
    f = _gated_sharded_fn(mesh, h, w, float(lambda_d), float(lambda_s),
                          float(sigma_d), float(sigma_s), int(iter_max),
                          float(error_min_threshold), int(fuse),
                          external_dt=mv is not None, sup_mode=sup_mode,
                          plateau_rtol=float(plateau_rtol))
    return f(*args)


@functools.lru_cache(maxsize=64)
def _gated_sharded_batched_fn(mesh: Mesh, h: int, w: int, lambda_d: float,
                              lambda_s: float, sigma_d: float,
                              sigma_s: float, iter_max: int,
                              error_min_threshold: float, fuse: int,
                              n_dirs: int, external_dt: bool = False,
                              sup_mode: str = "reference",
                              plateau_rtol: float = 0.0):
    """Batched variant of :func:`_gated_sharded_fn`: ``n_dirs`` reference
    frames (the flagship's two time directions,
    OpticalFlow_BlockMatching.cpp:84-93) refine against ONE interest
    frame in a single shard_map program — gx/gy/label halos and border
    masks are shared, the per-direction Jacobi chains are independent so
    they interleave, and each direction keeps its own
    per-element energy / 3-strikes early stop (a stopped direction's
    fields freeze while the other runs on — the serial semantics of
    ``irls_gradient_method_batched``)."""
    blocks_per_check = max(64 // fuse, 1)
    n_blocks = -(-iter_max // fuse)
    n_checks = max(-(-n_blocks // blocks_per_check), 1)

    def tile_body(int_t, refs_t, lab_t):
        th, tw = int_t.shape
        dt = int_t.dtype
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")
        xg = ix * tw + jnp.arange(tw)[None, :]
        yg = iy * th + jnp.arange(th)[:, None]
        at_xedge = jnp.broadcast_to(xg == w - 1, (th, tw))
        at_yedge = jnp.broadcast_to(yg == h - 1, (th, tw))

        gx, gy, taps = _grad_tile(int_t, at_xedge, at_yedge)
        if external_dt:
            # refine_warp: refs_t carries pre-computed per-direction
            # dt-under-BM-warp tiles (see _gated_sharded_fn).
            its = [refs_t[b] for b in range(n_dirs)]
        else:
            its = [_dt_zero_tile(refs_t[b], taps, at_xedge, at_yedge)
                   for b in range(n_dirs)]

        gx2 = lax.pmax(lax.pmax(jnp.max(gx * gx), "tx"), "ty")
        gy2 = lax.pmax(lax.pmax(jnp.max(gy * gy), "tx"), "ty")
        if sup_mode == "analytic":
            # True Geman-McClure curvature bound (bm_flow._gated_sup).
            sup_x = (lambda_d * gx2 * (2.0 / sigma_d)
                     + 4.0 * lambda_s * (2.0 / sigma_s))
            sup_y = (lambda_d * gy2 * (2.0 / sigma_d)
                     + 4.0 * lambda_s * (2.0 / sigma_s))
        else:
            sup_x = (lambda_d * gx2 / sigma_d**2
                     + 4.0 * lambda_s / sigma_s**2)
            sup_y = (lambda_d * gy2 / sigma_d**2
                     + 4.0 * lambda_s / sigma_s**2)

        row0 = iy * th - fuse
        col0 = ix * tw - fuse
        nb = nb_masks(row0, col0, th + 2 * fuse, tw + 2 * fuse, h, w, dt)
        gx_p = halo_pad_2d(gx, fuse)
        gy_p = halo_pad_2d(gy, fuse)
        it_ps = [halo_pad_2d(it, fuse) for it in its]
        lab_p = halo_pad_2d(lab_t, fuse)

        e_masks = {}
        for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ok = ((yg + dy >= 0) & (yg + dy < h)
                  & (xg + dx >= 0) & (xg + dx < w))
            e_masks[(dx, dy)] = jnp.broadcast_to(ok, (th, tw)).astype(dt)

        def energy_all(u, v):
            return jnp.stack([
                lax.psum(lax.psum(_gated_energy_tile(
                    u[b], v[b], lab_t, gx, gy, its[b], e_masks,
                    lambda_d, lambda_s, sigma_d, sigma_s), "tx"), "ty")
                for b in range(n_dirs)])

        def sweep_block(u, v, stop):
            outs = [irls_sweeps_gated(
                halo_pad_2d(u[b], fuse), halo_pad_2d(v[b], fuse),
                gx_p, gy_p, it_ps[b], lab_p, nb, sup_x, sup_y, fuse,
                lambda_d, lambda_s, sigma_d, sigma_s)
                for b in range(n_dirs)]
            u_new = jnp.stack([o[0] for o in outs])
            v_new = jnp.stack([o[1] for o in outs])
            active = jnp.logical_not(stop)[:, None, None]
            return jnp.where(active, u_new, u), jnp.where(active, v_new, v)

        def cond(carry):
            u, v, E, inc, b, stop, trace = carry
            return jnp.logical_and(b < n_blocks,
                                   jnp.logical_not(jnp.all(stop)))

        def body(carry):
            u, v, E, inc, b, stop, trace = carry
            u, v = sweep_block(u, v, stop)
            do_check = (b % blocks_per_check) == (blocks_per_check - 1)

            def check(args):
                u, v, E, inc, stop, trace = args
                E_new = jnp.where(stop, E, energy_all(u, v))
                inc_new = jnp.where(stop, inc,
                                    jnp.where(E_new > E, inc + 1, 0))
                k = b // blocks_per_check
                trace = trace.at[:, k].set(
                    jnp.where(stop, trace[:, k], E_new))
                stop_new = (stop | (E_new < error_min_threshold)
                            | (inc_new > 3))
                if plateau_rtol > 0.0:
                    # E: previous check's energy per direction (0 before
                    # the first check — plateau can't fire there).
                    stop_new = stop_new | (
                        (E > 0) & (E_new >= (1.0 - plateau_rtol) * E))
                return E_new, inc_new, stop_new, trace

            E, inc, stop, trace = lax.cond(
                do_check, check,
                lambda args: (args[2], args[3], args[4], args[5]),
                (u, v, E, inc, stop, trace))
            return u, v, E, inc, b + 1, stop, trace

        dtshape = (n_dirs, th, tw)
        E0 = jnp.zeros((n_dirs,), dt)
        trace0 = jnp.full((n_dirs, n_checks), jnp.nan, dt)
        u, v, E, _, b, _, trace = lax.while_loop(
            cond, body,
            (jnp.zeros(dtshape, dt), jnp.zeros(dtshape, dt), E0,
             jnp.zeros((n_dirs,), jnp.int32), jnp.int32(0),
             jnp.zeros((n_dirs,), bool), trace0))
        return u, v, trace

    from jax.sharding import PartitionSpec as P

    BSPEC = P(None, "ty", "tx")
    return jax.jit(shard_map(
        tile_body, mesh, in_specs=(SPEC, BSPEC, SPEC),
        out_specs=(BSPEC, BSPEC, P())))


def gradient_method_flow_sharded_bidirectional(
    reference_labs,
    interest_lab,
    labels,
    mesh: Mesh,
    lambda_d: float = 5.0,
    lambda_s: float = 1.0,
    sigma_d: float = 0.2 / np.sqrt(2.0),
    sigma_s: float = 0.03 / np.sqrt(2.0),
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    fuse: int = 8,
    mvs=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
):
    """Both time directions of the distributed gradient refine in ONE
    program (see :func:`_gated_sharded_batched_fn`). ``reference_labs``:
    sequence of B reference Lab frames. Returns ``([(u, v), ...],
    trace (B, n_checks))`` — each direction matches the serial
    :func:`gradient_method_flow_sharded` result, with one halo-exchange
    round per fused block shared between the directions' label/gradient
    operands. ``mvs`` (sequence of B (H, W, 2) BM fields) switches each
    direction's dt to the non-debug BM warp (refine_warp — see
    :func:`gradient_method_flow_sharded`)."""
    h, w = labels.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    if h // ty <= fuse or w // tx <= fuse:
        raise ValueError("tile smaller than the fused halo; lower fuse")
    from jax.sharding import PartitionSpec as P

    # Standard Lab units — matches the single-device refine.
    interest_l = jnp.asarray(interest_lab)[..., 0] * LAB_SCALE
    if mvs is not None:
        from tpuflow.solvers.bm_flow import gradient_method_dt

        refs_l = jnp.stack([
            gradient_method_dt(jnp.asarray(r)[..., 0] * LAB_SCALE,
                               interest_l, mv[..., 0], mv[..., 1])
            for r, mv in zip(reference_labs, mvs)])
    else:
        refs_l = jnp.stack([jnp.asarray(r)[..., 0] * LAB_SCALE
                            for r in reference_labs])
    dt = interest_l.dtype
    args = [
        jax.device_put(interest_l, NamedSharding(mesh, SPEC)),
        jax.device_put(refs_l, NamedSharding(mesh, P(None, "ty", "tx"))),
        jax.device_put(jnp.asarray(labels).astype(dt),
                       NamedSharding(mesh, SPEC)),
    ]
    f = _gated_sharded_batched_fn(
        mesh, h, w, float(lambda_d), float(lambda_s), float(sigma_d),
        float(sigma_s), int(iter_max), float(error_min_threshold),
        int(fuse), len(reference_labs), external_dt=mvs is not None,
        sup_mode=sup_mode, plateau_rtol=float(plateau_rtol))
    u, v, trace = f(*args)
    return [(u[b], v[b]) for b in range(len(reference_labs))], trace


def _mirror_idx(i, n: int):
    """img.get_mirror index fold (same formula as
    tpuflow.solvers.bm_flow.gradient_method_dt)."""
    i = jnp.abs(i)
    period = 2 * n - 2 if n > 1 else 1
    i = i % period
    return jnp.where(i >= n, period - i, i)


def _warp_dt_tile(int_t, ref_t, mv_u, mv_v, row0, col0, h: int, w: int,
                  R: int, at_xedge, at_yedge):
    """4-tap dt under the floor(MV) warp on a tile
    (OpticalFlow_BlockMatching.cpp:385-397): the reference tile carries
    an R-wide ppermute halo sized for the displacement bound, the warped
    reads resolve locally (mirror folds at the global border stay within
    the halo when R >= 2 * (max|MV| + 2)); the interest taps are the
    static mirror shifts. Bitwise the op order of gradient_method_dt."""
    th, tw = int_t.shape
    int_p = halo_pad_2d(int_t, 1)
    ref_p = halo_pad_2d(ref_t, R)
    xs_g = jnp.broadcast_to(col0 + jnp.arange(tw)[None, :], (th, tw))
    ys_g = jnp.broadcast_to(row0 + jnp.arange(th)[:, None], (th, tw))
    xt = xs_g + jnp.floor(mv_u).astype(jnp.int32)
    yt = ys_g + jnp.floor(mv_v).astype(jnp.int32)

    def ref_at(ddx, ddy):
        gy = _mirror_idx(yt + ddy, h)
        gx = _mirror_idx(xt + ddx, w)
        ly = jnp.clip(gy - row0 + R, 0, th + 2 * R - 1)
        lx = jnp.clip(gx - col0 + R, 0, tw + 2 * R - 1)
        return ref_p[ly, lx]

    def int_at(ddx, ddy):
        return _fwd_mirror(int_p, ddx, ddy, at_xedge, at_yedge, th, tw)

    return (ref_at(0, 0) - int_at(0, 0)
            + ref_at(1, 0) - int_at(1, 0)
            + ref_at(0, 1) - int_at(0, 1)
            + ref_at(1, 1) - int_at(1, 1)) / 4.0


@functools.lru_cache(maxsize=64)
def _affine_sharded_fn(mesh: Mesh, h: int, w: int, n_regions: int,
                       sigma: float, iter_max: int,
                       error_min_threshold: float, normalize_steps: bool,
                       R: int):
    def tile_body(int_t, ref_t, lab_t, mvu_t, mvv_t):
        th, tw = int_t.shape
        dt = int_t.dtype
        iy = lax.axis_index("ty")
        ix = lax.axis_index("tx")
        row0 = iy * th
        col0 = ix * tw
        xg = col0 + jnp.arange(tw)[None, :]
        yg = row0 + jnp.arange(th)[:, None]
        at_xedge = jnp.broadcast_to(xg == w - 1, (th, tw))
        at_yedge = jnp.broadcast_to(yg == h - 1, (th, tw))

        # gx, gy from the interest tile (gradient_method_grad op order).
        int_p = halo_pad_2d(int_t, 1)
        i00 = _fwd_mirror(int_p, 0, 0, at_xedge, at_yedge, th, tw)
        i10 = _fwd_mirror(int_p, 1, 0, at_xedge, at_yedge, th, tw)
        i01 = _fwd_mirror(int_p, 0, 1, at_xedge, at_yedge, th, tw)
        i11 = _fwd_mirror(int_p, 1, 1, at_xedge, at_yedge, th, tw)
        gx = ((i10 - i00) + (i11 - i01)) / 2.0
        gy = ((i01 - i00) + (i11 - i10)) / 2.0
        it = _warp_dt_tile(int_t, ref_t, mvu_t, mvv_t, row0, col0, h, w,
                           R, at_xedge, at_yedge)

        x = xg.astype(dt) * jnp.ones((th, 1), dt)
        y = yg.astype(dt) * jnp.ones((1, tw), dt)
        basis = jnp.stack([gx, gx * x, gx * y, gy, gy * x, gy * y], axis=0)
        flat = lab_t.reshape(-1)

        def seg(f):
            local = jax.ops.segment_sum(f.reshape(-1), flat,
                                        num_segments=n_regions)
            return lax.psum(lax.psum(local, "tx"), "ty")

        def seg_max(f):
            local = jax.ops.segment_max(f.reshape(-1), flat,
                                        num_segments=n_regions)
            return lax.pmax(lax.pmax(local, "tx"), "ty")

        sup = jnp.stack([2.0 * seg_max(basis[i] ** 2) / sigma**2
                         for i in range(6)], axis=-1)
        omega = 1.0
        tiny = jnp.abs(sup) < 1.0e-10
        step = jnp.where(tiny,
                         omega * 1.0e10 * jnp.where(sup >= 0, 1.0, -1.0),
                         omega / jnp.where(tiny, 1.0, sup))
        if normalize_steps:
            counts = seg(jnp.ones((th, tw), dt))
            step = step / jnp.maximum(counts, 1.0)[:, None]

        def flow_of(a):
            a_pix = a[lab_t]
            u = a_pix[..., 0] + a_pix[..., 1] * x + a_pix[..., 2] * y
            v = a_pix[..., 3] + a_pix[..., 4] * x + a_pix[..., 5] * y
            return u, v

        def energy_of(a):
            u, v = flow_of(a)
            r = geman_mcclure_rho(gx * u + gy * v + it, sigma)
            return seg(r)

        def body(n, carry):
            a, done = carry
            u, v = flow_of(a)
            psi = geman_mcclure_psi(gx * u + gy * v + it, sigma)
            dE = jnp.stack([seg(basis[i] * psi) for i in range(6)],
                           axis=-1)
            a_new = a - step * dE
            a = jnp.where(done[:, None], a, a_new)
            E = energy_of(a)
            done = jnp.logical_or(done, E < error_min_threshold)
            return a, done

        a0 = jnp.zeros((n_regions, 6), dt)
        done0 = jnp.zeros((n_regions,), bool)
        a, _ = lax.fori_loop(0, iter_max, body, (a0, done0))
        u, v = flow_of(a)
        return a, u, v

    from jax.sharding import PartitionSpec as P

    return jax.jit(shard_map(
        tile_body, mesh, in_specs=(SPEC,) * 5,
        out_specs=(P(), SPEC, SPEC)))


def affine_parametric_flow_sharded(
    reference_lab,
    interest_lab,
    mv_u,
    mv_v,
    labels,
    n_regions: int,
    mesh: Mesh,
    sigma: float = 0.2 / np.sqrt(2.0),
    iter_max: int = 256,
    error_min_threshold: float = 1.0e-6,
    normalize_steps: bool = False,
    max_displacement: int | None = None,
):
    """Distributed AffineParametric (Affine_BlockMatching.cpp:11-77):
    per-region 6-parameter robust fit of the residual under the BM warp,
    segment reductions psum'd over the mesh, parameter tables replicated.
    Returns (a (n_regions, 6), u, v). ``max_displacement`` bounds |MV|
    for the warp halo (default: its observed max)."""
    from tpuflow.blockmatching.matcher import region_bucket

    h, w = labels.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    if max_displacement is None:
        # Host fetch — pass an explicit bound to keep dispatch sync-free.
        mv_u_np = np.asarray(mv_u)
        mv_v_np = np.asarray(mv_v)
        max_displacement = int(np.ceil(max(
            float(np.max(np.abs(mv_u_np))), float(np.max(np.abs(mv_v_np))),
            0.0)))
    R = 2 * (int(max_displacement) + 2)
    if h // ty <= R or w // tx <= R:
        raise ValueError("tile smaller than the warp halo; shrink the "
                         "displacement bound or the mesh")
    # Standard Lab units — matches the single-device
    # affine_parametric_flow.
    interest_l = jnp.asarray(interest_lab)[..., 0] * LAB_SCALE
    reference_l = jnp.asarray(reference_lab)[..., 0] * LAB_SCALE
    dt = interest_l.dtype
    n_pad = region_bucket(int(n_regions))
    sharding = NamedSharding(mesh, SPEC)
    args = [jax.device_put(jnp.asarray(a), sharding)
            for a in (interest_l, reference_l, jnp.asarray(labels),
                      jnp.asarray(mv_u, dt), jnp.asarray(mv_v, dt))]
    f = _affine_sharded_fn(mesh, h, w, n_pad, float(sigma), int(iter_max),
                           float(error_min_threshold),
                           bool(normalize_steps), int(R))
    a, u, v = f(*args)
    return a[: int(n_regions)], u, v
