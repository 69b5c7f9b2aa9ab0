"""Distributed (multi-chip) Farneback dense flow: 2-D image tiling.

The reference runs dense Farneback through OpenCV in two production
configs, both single-level — the pair demo (0.5, 1, 64, 2, 8, 1.6)
(``FarnebackOF/FarnebackOF.cpp:24``) and the streaming config
(0.4, 1, 48, 2, 8, 1.2) (``VideoDenseOF/DenseFlow.cpp:37``). Its only
parallelism is OpenCV's internal threading (SURVEY.md §2.6); the
multi-device equivalent here is image-domain decomposition over a ("ty", "tx")
device mesh, the same comm backend as the variational solvers
(tpuflow/dist/solvers.py).

Every stage of single-level Farneback is window-local, so each tiles
cleanly with a bounded halo:

- polynomial expansion: separable (2*poly_n+1)-tap convs -> poly_n halo;
- the warp gather of ``update_matrices``: bounded by ``warp_halo``
  (default winsize) — displacement estimates beyond the exchanged halo
  clamp to its edge (exact whenever |flow| <= warp_halo, which the
  winsize^2 aggregation enforces in practice);
- the winsize^2 box aggregation: winsize//2 halo;
- the 2x2 solve: pointwise.

CLAMP (replicate) borders — OpenCV's convention for all three stages —
are reproduced at global image borders by :func:`halo_pad_2d_clamp`;
interior tile borders receive true neighbor data via ppermute, so the
tiled solve matches the single-device solve bitwise (equivalence test on
the virtual CPU mesh, tests/test_dist.py).

The next-frame coefficient halos are exchanged ONCE per frame (they are
iteration-invariant); per iteration only the 5-channel M field exchanges
a winsize//2 halo. Multi-level configs (only the HS-demo comparison
config, HornSchunckOF/main.cpp:111) replicate the coarse levels — they
are small — and tile only the finest level, warm-started with the
prolonged coarse flow (the dist/pyramid.py scheme).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuflow.dist.halo import shift_along
from tpuflow.dist.solvers import shard_map
from tpuflow.solvers.farneback import (
    _BORDER,
    _poly_coefficients,
    _poly_exp_matrices,
    _solve_flow,
)


def halo_pad_2d_clamp(tile: jnp.ndarray, r: int,
                      ty_axis: str = "ty", tx_axis: str = "tx"):
    """Halo-pad a (h, w) tile to (h + 2r, w + 2r) with CLAMP semantics.

    Interior halos come from mesh neighbors (ppermute); halos that fall
    outside the global image replicate the tile's own edge — exactly
    ``jnp.pad(..., mode="edge")`` of the assembled image (corners
    replicate the corner pixel because x pads before y, matching
    ``tpuflow.core.borders.pad2d`` CLAMP).
    """
    ny = lax.axis_size(ty_axis)
    nx = lax.axis_size(tx_axis)
    iy = lax.axis_index(ty_axis)
    ix = lax.axis_index(tx_axis)
    left = shift_along(tile[:, -r:], tx_axis, +1)
    left = jnp.where(ix == 0, jnp.broadcast_to(tile[:, :1], left.shape),
                     left)
    right = shift_along(tile[:, :r], tx_axis, -1)
    right = jnp.where(ix == nx - 1,
                      jnp.broadcast_to(tile[:, -1:], right.shape), right)
    wide = jnp.concatenate([left, tile, right], axis=1)
    top = shift_along(wide[-r:, :], ty_axis, +1)
    top = jnp.where(iy == 0, jnp.broadcast_to(wide[:1, :], top.shape), top)
    bottom = shift_along(wide[:r, :], ty_axis, -1)
    bottom = jnp.where(iy == ny - 1,
                       jnp.broadcast_to(wide[-1:, :], bottom.shape), bottom)
    return jnp.concatenate([top, wide, bottom], axis=0)


def _conv2d_valid(padded: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """VALID 2-D correlation — must stay the exact formulation of
    tpuflow.ops.filters._conv2d_valid so the tiled convs are bitwise
    identical to the single-device path."""
    from tpuflow.ops.filters import _conv2d_valid as impl

    return impl(padded, kernel)


def _sep_valid(padded, kx: np.ndarray, ky: np.ndarray):
    """Separable VALID conv on a pre-halo'd tile: the outer-product conv
    of sep_conv2d, so tiled == single-device bitwise."""
    k2 = (jnp.asarray(ky, padded.dtype)[:, None]
          * jnp.asarray(kx, padded.dtype)[None, :])
    return _conv2d_valid(padded, k2)


def _poly_tile(tile, poly_n: int, poly_sigma: float):
    """Per-tile polynomial expansion (solvers/farneback.py
    poly_expansion) with halo-exchanged CLAMP borders."""
    n = poly_n
    g, Ginv = _poly_exp_matrices(n, poly_sigma)
    xs = np.arange(-n, n + 1, dtype=np.float64)
    gx = g * xs
    gxx = g * xs * xs
    padded = halo_pad_2d_clamp(tile, n)

    def m(ky, kx):
        return _sep_valid(padded, kx, ky)

    moments = [m(g, g), m(g, gx), m(gx, g), m(g, gxx), m(gxx, g), m(gx, gx)]
    return _poly_coefficients(moments, Ginv)


def _warp_dense_tile(R2_halo, u, v, D: int, wh: int):
    """Tiled :func:`tpuflow.solvers.farneback._warp_dense`: the bilinear
    warp as a static (2D+2)^2 shifted-slice sweep over the halo'd R2
    stack (valid whenever the GLOBAL flow bound <= D <= wh - 1; the
    caller cond-dispatches on a pmax'd bound so every device takes the
    same branch). Taps are plain dynamic_slices of the exchanged halo —
    true neighbor-tile data interior, clamp replicas at global borders,
    exactly like the gather path's index clamp."""
    th, tw = u.shape
    c = R2_halo.shape[-1]
    acc = jnp.zeros((th, tw, c), u.dtype)
    for dy in range(-D, D + 2):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(v - dy))
        for dx in range(-D, D + 2):
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(u - dx))
            tap = lax.dynamic_slice(R2_halo, (wh + dy, wh + dx, 0),
                                    (th, tw, c))
            acc = acc + (wx * wy)[..., None] * tap
    return acc


def _update_matrices_tile(R1, R2_halo_packed, u, v, row0, col0,
                          img_h: int, img_w: int, wh: int,
                          zero_flow: bool, R2_center=None,
                          R2_halo=None, dense_warp_d: int = 0):
    """Tiled update_matrices (solvers/farneback.py): global-coordinate
    border logic, warp gather served from the halo'd next-frame
    coefficient stack (exchanged once per frame).

    R2_halo_packed: ((th+2wh)*(tw+2wh), 20) packed 2x2-neighborhood
    table of the halo'd R2 stack (solvers.farneback._pack_bilinear —
    ONE gather per pixel instead of four; the gather is
    index-rate-bound). The packed neighbors edge-clamp inside the halo
    array, which equals the old per-corner clamp: interior corners are
    true neighbors, and at the halo (or global) edge the clamp-padded
    replica IS the clamped corner.
    """
    b1_1, b2_1, a11_1, a22_1, a12_1 = R1
    th, tw = u.shape
    dt = u.dtype
    lx = jnp.arange(tw, dtype=dt)[None, :]
    ly = jnp.arange(th, dtype=dt)[:, None]
    gxs = col0.astype(dt) + lx  # global pixel coords
    gys = row0.astype(dt) + ly
    if zero_flow:
        b1_2, b2_2, a11_2, a22_2, a12_2 = R2_center
        a11 = (a11_1 + a11_2) * 0.5
        a12 = (a12_1 + a12_2) * 0.5
        a22 = (a22_1 + a22_2) * 0.5
        db1 = (b1_1 - b1_2) * 0.5
        db2 = (b2_1 - b2_2) * 0.5
    else:
        hw_ = tw + 2 * wh
        xq = gxs + u  # global query
        yq = gys + v
        inb = (xq >= 0) & (xq < img_w) & (yq >= 0) & (yq < img_h)
        x0 = jnp.floor(xq).astype(jnp.int32)
        y0 = jnp.floor(yq).astype(jnp.int32)
        fx = (xq - x0)[..., None]
        fy = (yq - y0)[..., None]
        # Global clamp (reference semantics) then local clamp into the
        # exchanged halo (deviates only when |flow| > wh).
        def gather_warp():
            yy = jnp.clip(jnp.clip(y0, 0, img_h - 1) - row0 + wh,
                          0, th + 2 * wh - 1)
            xx = jnp.clip(jnp.clip(x0, 0, img_w - 1) - col0 + wh,
                          0, tw + 2 * wh - 1)
            rows = jnp.take(R2_halo_packed, (yy * hw_ + xx).reshape(-1),
                            axis=0).reshape(th, tw, 20)
            s00 = rows[..., :5]
            s01 = rows[..., 5:10]
            s10 = rows[..., 10:15]
            s11 = rows[..., 15:20]
            return ((1 - fx) * (1 - fy) * s00 + fx * (1 - fy) * s01
                    + (1 - fx) * fy * s10 + fx * fy * s11)

        if dense_warp_d > 0 and R2_halo is not None:
            # Global (pmax'd) flow bound — every device takes the same
            # branch; the dense branch reads only the exchanged halo.
            dloc = jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v)))
            dmax = lax.pmax(lax.pmax(dloc, "tx"), "ty")
            out = lax.cond(
                dmax <= dense_warp_d,
                lambda: _warp_dense_tile(R2_halo, u, v, dense_warp_d, wh),
                gather_warp)
        else:
            out = gather_warp()
        b1_2, b2_2, a11_2, a22_2, a12_2 = (out[..., i] for i in range(5))

        a11 = (a11_1 + a11_2) * 0.5
        a12 = (a12_1 + a12_2) * 0.5
        a22 = (a22_1 + a22_2) * 0.5
        db1 = (b1_1 - b1_2) * 0.5
        db2 = (b2_1 - b2_2) * 0.5
        a11 = jnp.where(inb, a11, a11_1 * 0.5)
        a12 = jnp.where(inb, a12, a12_1 * 0.5)
        a22 = jnp.where(inb, a22, a22_1 * 0.5)
        db1 = jnp.where(inb, db1, 0.0)
        db2 = jnp.where(inb, db2, 0.0)
        db1 = db1 + a11 * u + a12 * v
        db2 = db2 + a12 * u + a22 * v

    dist = jnp.minimum(jnp.minimum(gxs, img_w - 1 - gxs),
                       jnp.minimum(gys, img_h - 1 - gys))
    scale = jnp.clip((dist + 1.0) / (_BORDER + 1.0), 0.0, 1.0)
    scale = jnp.broadcast_to(scale, (th, tw))
    a11, a12, a22 = a11 * scale, a12 * scale, a22 * scale
    db1, db2 = db1 * scale, db2 * scale

    m11 = a11 * a11 + a12 * a12
    m12 = a12 * (a11 + a22)
    m22 = a12 * a12 + a22 * a22
    h1 = a11 * db1 + a12 * db2
    h2 = a12 * db1 + a22 * db2
    return jnp.stack([m11, m12, m22, h1, h2], axis=0)


def _blur_solve_tile(M, winsize: int):
    """Tiled _blur_solve: halo'd box aggregation + pointwise 2x2 solve
    (even-winsize anchor crop as in solvers/farneback.py _blur_same)."""
    th, tw = M.shape[1], M.shape[2]
    m = winsize // 2
    Mp = jnp.stack([halo_pad_2d_clamp(c, m) for c in M], axis=0)
    k = np.full(winsize, 1.0 / winsize)
    blurred = jnp.stack(
        [_sep_valid(c, k, k)[:th, :tw] for c in Mp], axis=0)
    return _solve_flow(blurred)


@functools.lru_cache(maxsize=64)
def _fb_sharded_fn(mesh: Mesh, h: int, w: int, winsize: int,
                   iterations: int, poly_n: int, poly_sigma: float,
                   wh: int, with_init: bool = False,
                   dense_warp_d: int = 0):
    ty, tx = mesh.devices.shape
    th, tw = h // ty, w // tx
    spec = P("ty", "tx")

    def tile_body(p_t, n_t, u, v):
        row0 = lax.axis_index("ty") * th
        col0 = lax.axis_index("tx") * tw
        R1 = _poly_tile(p_t, poly_n, poly_sigma)
        R2 = _poly_tile(n_t, poly_n, poly_sigma)
        # Halo'd R2 stack, exchanged + packed once — iteration-invariant.
        from tpuflow.solvers.farneback import _pack_bilinear

        R2h_list = [halo_pad_2d_clamp(c, wh) for c in R2]
        R2h_flat = _pack_bilinear(R2h_list)
        R2_halo = (jnp.stack(R2h_list, axis=-1)
                   if dense_warp_d > 0 else None)

        if not with_init:
            u = jnp.zeros((th, tw), p_t.dtype)
            v = jnp.zeros((th, tw), p_t.dtype)
            M = _update_matrices_tile(R1, R2h_flat, u, v, row0, col0, h, w,
                                      wh, True, R2_center=R2)
        else:
            # Coarse-level warm start (multi-level configs): the first
            # update already warps by the prolonged flow, exactly like
            # the single-device level-0 step (_farneback_impl).
            M = _update_matrices_tile(R1, R2h_flat, u, v, row0, col0, h, w,
                                      wh, False, R2_halo=R2_halo,
                                      dense_warp_d=dense_warp_d)
        for i in range(iterations):
            u, v = _blur_solve_tile(M, winsize)
            if i < iterations - 1:
                M = _update_matrices_tile(R1, R2h_flat, u, v, row0, col0,
                                          h, w, wh, False,
                                          R2_halo=R2_halo,
                                          dense_warp_d=dense_warp_d)
        return u, v

    if with_init:
        return jax.jit(shard_map(
            tile_body, mesh, in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec)))
    fn = jax.jit(shard_map(lambda p, n: tile_body(p, n, None, None),
                           mesh, in_specs=(spec, spec),
                           out_specs=(spec, spec)))
    return lambda p, n, u, v: fn(p, n)


def farneback_sharded(
    prev: jnp.ndarray,
    nxt: jnp.ndarray,
    mesh: Mesh,
    pyr_scale: float = 0.5,
    levels: int = 1,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
    flags: int = 0,
    warp_halo: int | None = None,
    dense_warp_d: int = 4,
):
    """Distributed Farneback flow over a ("ty", "tx") mesh.

    Matches calc_optical_flow_farneback(flags=0) whenever
    |flow| <= warp_halo. Both reference dense-flow production configs
    are single-level (levels=1); multi-level configs (the HS-demo
    comparison config 0.5/3/15/3/5/1.2, ``HornSchunckOF/main.cpp:111``)
    run levels ``levels-1..1`` REPLICATED through the single-device
    coarse-to-fine loop (coarse levels are tiny — the dist/pyramid.py
    scheme) and tile only the finest level, warm-started with the
    prolonged coarse flow. Returns (u, v) sharded over the mesh.
    """
    if flags & 0x300:
        raise ValueError("farneback_sharded: initial-flow/gaussian flags "
                         "not supported in the tiled path")
    h, w = prev.shape
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    th, tw = h // ty, w // tx
    wh = winsize if warp_halo is None else warp_halo
    wh = min(wh, th, tw)
    if dense_warp_d + 1 > wh:
        dense_warp_d = 0  # dense taps must fit the exchanged halo
    m = winsize // 2
    if m > th or m > tw or poly_n > th or poly_n > tw:
        raise ValueError("tile smaller than a required halo")

    prev = jnp.asarray(prev)
    nxt = jnp.asarray(nxt)
    u0 = v0 = None
    if levels > 1:
        # Coarse levels replicated through the exact single-device loop
        # (min_level=1 stops before the finest level), then prolonged to
        # full resolution the way _farneback_impl's level-0 step does.
        from tpuflow.solvers.farneback import _farneback_impl

        uc, vc = _farneback_impl(prev, nxt, None, None, float(pyr_scale),
                                 int(levels), int(winsize),
                                 int(iterations), int(poly_n),
                                 float(poly_sigma), False, min_level=1)
        u0 = jax.image.resize(uc, (h, w), method="linear") / pyr_scale
        v0 = jax.image.resize(vc, (h, w), method="linear") / pyr_scale

    sharding = NamedSharding(mesh, P("ty", "tx"))
    prev = jax.device_put(prev, sharding)
    nxt = jax.device_put(nxt, sharding)
    f = _fb_sharded_fn(mesh, h, w, int(winsize), int(iterations),
                       int(poly_n), float(poly_sigma), int(wh),
                       with_init=levels > 1,
                       dense_warp_d=int(dense_warp_d))
    if levels > 1:
        u0 = jax.device_put(u0, sharding)
        v0 = jax.device_put(v0, sharding)
    return f(prev, nxt, u0, v0)
