"""Farneback dense optical flow: polynomial expansion + displacement update.

The reference calls OpenCV's ``calcOpticalFlowFarneback`` in three configs
(``FarnebackOF/FarnebackOF.cpp:24`` (0.5,1,64,2,8,1.6),
``VideoDenseOF/DenseFlow.cpp:37`` (0.4,1,48,2,8,1.2),
``HornSchunckOF/main.cpp:111`` (0.5,3,15,3,5,1.2)). This module implements
the *algorithm* from Farneback (2003, "Two-frame motion estimation based on
polynomial expansion") with OpenCV's parameterization and conventions:

- per-pixel quadratic expansion f(x) ~ x^T A x + b^T x + c via separable
  Gaussian-weighted least squares over a (2 poly_n + 1)^2 window
  (poly_n is the half-width, as in OpenCV);
- displacement from averaged A and warped-b difference, aggregated over a
  winsize^2 box (flags=0 path) and solved as per-pixel 2x2 systems;
- image pyramid by Gaussian-smooth + bilinear resize with
  sigma = (1/scale - 1)/2 per level, flow upscaled by 1/pyr_scale;
- OpenCV's 5-px border down-weighting of the matrix updates.

Design: everything is separable convolutions, bilinear warps and
pointwise 2x2 solves — no data-dependent shapes; the whole per-level
iteration is jit-fused. Validated against cv2.calcOpticalFlowFarneback in
tests/test_farneback.py (tolerance, not bitwise — OpenCV's internals use
float32 with its own blur order).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.core import borders as bd
from tpuflow.ops.filters import sep_conv2d

_BORDER = 5  # OpenCV FarnebackUpdateMatrices border band


def _poly_exp_matrices(n: int, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian applicability g and the 6x6 normal-equation inverse G^-1.

    Basis ordering: [1, x, y, x^2, y^2, xy] (Farneback eq. 4.6 / OpenCV
    FarnebackPrepareGaussian).
    """
    xs = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    g /= g.sum()
    X, Y = np.meshgrid(xs, xs)
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(X), X, Y, X**2, Y**2, X * Y], axis=0)
    G = np.einsum("iyx,jyx,yx->ij", basis, basis, w)
    return g, np.linalg.inv(G)


def _poly_coefficients(moments, Ginv: np.ndarray):
    """(b1, b2, a11, a22, a12) from the six Gaussian moments
    [m00, m10, m01, m20, m02, m11] by the G^-1 combination."""
    r = jnp.einsum("hwk,jk->hwj", jnp.stack(moments, axis=-1),
                   jnp.asarray(Ginv, moments[0].dtype),
                   precision=jax.lax.Precision.HIGHEST)
    return r[..., 1], r[..., 2], r[..., 3], r[..., 4], r[..., 5] * 0.5


def poly_expansion(img: jnp.ndarray, poly_n: int, poly_sigma: float):
    """Quadratic expansion coefficients (b1, b2, a11, a22, a12) per pixel.

    f(x + dx) ~ c + b.dx + dx^T A dx with A = [[a11, a12], [a12, a22]].
    Border: replicate (OpenCV PolyExp clamps source rows/cols).
    """
    n = poly_n
    g, Ginv = _poly_exp_matrices(n, poly_sigma)
    xs = np.arange(-n, n + 1, dtype=np.float64)
    gx = g * xs
    gxx = g * xs * xs

    # Separable moments: rows then columns (correlation orientation; the
    # kernels are symmetric/antisymmetric so orientation matters only for
    # the odd ones — x of gx increases rightward like the basis).
    def m(ky, kx):
        return sep_conv2d(img, kx, ky, border=bd.CLAMP)

    # Sum w * f, w*x*f, w*y*f, w*x^2*f, w*y^2*f, w*x*y*f.
    moments = [m(g, g), m(g, gx), m(gx, g), m(g, gxx), m(gxx, g), m(gx, gx)]
    return _poly_coefficients(moments, Ginv)


def _pack_bilinear(fields, dtype=None):
    """Pack each pixel's 2x2 clamped neighborhood of every field into one
    (H*W, 4C) row table: row i = [F(y,x), F(y,x+1), F(y+1,x),
    F(y+1,x+1)] (neighbors edge-clamped), so one row gather serves all
    four bilinear corners of every field. The table is built once per
    level and shared by every update_matrices call. ``dtype`` (e.g.
    bfloat16) stores the table at reduced precision, halving the
    gathered bytes at ~3-decimal-digit coefficient rounding
    (documented-tolerance opt-in; interpolation runs in f32 either
    way)."""
    F = jnp.stack(fields, axis=-1)                            # (H, W, C)
    Fx = jnp.concatenate([F[:, 1:], F[:, -1:]], axis=1)       # x+1 clamped
    Fy = jnp.concatenate([F[1:], F[-1:]], axis=0)             # y+1 clamped
    Fxy = jnp.concatenate([Fx[1:], Fx[-1:]], axis=0)
    h, w = F.shape[:2]
    out = jnp.concatenate([F, Fx, Fy, Fxy],
                          axis=-1).reshape(h * w, 4 * len(fields))
    return out if dtype is None else out.astype(dtype)


def _bilinear_all(fields, xq, yq, packed=None):
    """Bilinear-sample each (H, W) field at float (xq, yq), clamped.

    ONE row gather from the packed 2x2-neighborhood table
    (:func:`_pack_bilinear`) serves all four corners of every field.
    Exactly equal to the four-corner clamped gather wherever the query
    is in-bounds (the only values update_matrices keeps — out-of-bounds
    pixels are masked by ``inb``); at in-bounds queries the base index
    needs no clamping and each packed neighbor IS the clamped corner."""
    h, w = xq.shape
    n = len(fields)
    x0 = jnp.floor(xq).astype(jnp.int32)
    y0 = jnp.floor(yq).astype(jnp.int32)
    fx = (xq - x0)[..., None]
    fy = (yq - y0)[..., None]
    if packed is None:
        packed = _pack_bilinear(fields)
    idx = jnp.clip(y0, 0, h - 1) * w + jnp.clip(x0, 0, w - 1)
    rows = jnp.take(packed, idx.reshape(-1),
                    axis=0).reshape(h, w, 4 * n).astype(xq.dtype)
    s00 = rows[..., :n]
    s01 = rows[..., n:2 * n]
    s10 = rows[..., 2 * n:3 * n]
    s11 = rows[..., 3 * n:]
    out = ((1 - fx) * (1 - fy) * s00 + fx * (1 - fy) * s01
           + (1 - fx) * fy * s10 + fx * fy * s11)
    return [out[..., i] for i in range(n)]


def _warp_dense(R2, u, v, D: int):
    """Bilinear warp of the 5-field R2 stack by dense masked SHIFTS —
    exact (up to weight-rounding ulps) whenever max(|u|, |v|) <= D.

    For bounded displacements the bilinear gather is a static (2D+2)^2
    sweep of plain shifted slices with hat weights max(0, 1-|u-dx|):
    dense elementwise work instead of a per-pixel gather. Edge padding
    replicates (matches the gather's index clamp for every in-bounds
    query; out-of-bounds queries are masked by ``inb`` either way)."""
    h, w = u.shape
    F = jnp.stack(R2, axis=-1)
    Fp = jnp.pad(F, ((D + 1, D + 1), (D + 1, D + 1), (0, 0)),
                 mode="edge")
    acc = jnp.zeros((h, w, len(R2)), F.dtype)
    for dy in range(-D, D + 2):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(v - dy))
        for dx in range(-D, D + 2):
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(u - dx))
            tap = jax.lax.dynamic_slice(
                Fp, (D + 1 + dy, D + 1 + dx, 0), (h, w, len(R2)))
            acc = acc + (wx * wy)[..., None] * tap
    return [acc[..., i] for i in range(len(R2))]


def _warp_tiled(R2, u, v, packed, D: int = 2, S: int = 128,
                th: int = 64, tw: int = 256):
    """Exact large-motion warp: per-tile integer pre-shift + bounded
    dense residual sweep, per-tile gather fallback.

    For large motion the flow is still piecewise smooth:
    split the frame into (th, tw) tiles, take each tile's rounded mean
    flow as an integer pre-shift s (|s| <= S), fetch the tile's
    pre-shifted block with ONE ``dynamic_slice`` (a contiguous copy,
    not a gather), and interpolate the residual r = flow
    - s with the (2D+2)^2 hat-weight shifted-slice sweep of
    :func:`_warp_dense` — exact whenever max|r| <= D over the tile.
    Tiles that violate the residual bound (motion-boundary tiles — a
    few per frame) fall back to the bitwise gather formula
    per tile, so the result equals the full gather warp up to
    weight-rounding ulps on smooth tiles and bitwise on fallback
    tiles, for ARBITRARY flow magnitude.

    Scanned over tile rows (hn steps) with the tile-column loop
    unrolled: each band issues wn dynamic slices + dense sweeps — no
    per-pixel indexing anywhere on the smooth path.

    Defaults (D=2, th=64, tw=256): larger tiles see more within-tile
    spread in the solver's intermediate flow fields and take the gather
    fallback more often."""
    h, w = u.shape
    C = len(R2)
    dt = u.dtype
    if packed is None:
        packed = _pack_bilinear(R2)
    hn = -(-h // th)
    wn = -(-w // tw)
    hp, wp = hn * th, wn * tw
    PAD = S + D + 1
    F = jnp.stack(R2, axis=-1)
    Fp = jnp.pad(F, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    Fp = jnp.pad(Fp, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="edge")
    up = jnp.pad(u, ((0, hp - h), (0, wp - w)), mode="edge")
    vp = jnp.pad(v, ((0, hp - h), (0, wp - w)), mode="edge")
    ut = up.reshape(hn, th, wn, tw).transpose(0, 2, 1, 3)  # (hn,wn,th,tw)
    vt = vp.reshape(hn, th, wn, tw).transpose(0, 2, 1, 3)
    # Pixels whose query leaves the FRAME are masked by every caller
    # (update_matrices' `inb` — OpenCV's own convention), so their
    # sampled values are don't-cares: exclude them from the tile's
    # shift mean and residual bound. Without this, ONE degenerate-solve
    # outlier pixel (the det-clamped 2x2 solve emits +-1e6 flows on
    # flat patches) would condemn its whole tile to the gather
    # fallback.
    cx = jnp.broadcast_to(
        jnp.arange(wp, dtype=dt).reshape(1, wn, 1, tw), ut.shape)
    cy = jnp.broadcast_to(
        jnp.arange(hp, dtype=dt).reshape(hn, 1, th, 1), ut.shape)
    xq_t = cx + ut
    yq_t = cy + vt
    m = ((xq_t >= 0) & (xq_t < w) & (yq_t >= 0)
         & (yq_t < h)).astype(dt)
    cnt = jnp.maximum(m.sum(axis=(2, 3)), 1.0)
    s_u = jnp.clip(jnp.round((ut * m).sum(axis=(2, 3)) / cnt), -S, S)
    s_v = jnp.clip(jnp.round((vt * m).sum(axis=(2, 3)) / cnt), -S, S)
    # Masked residuals vs the CLIPPED shift: a tile whose true (valid-
    # query) mean exceeds S shows the overflow in r and fails the
    # bound -> gather fallback; out-of-frame pixels contribute zero
    # residual (their dense taps sample garbage that the caller masks).
    r_u = (ut - s_u[:, :, None, None]) * m
    r_v = (vt - s_v[:, :, None, None]) * m
    ok = ((jnp.max(jnp.abs(r_u), axis=(2, 3)) <= D)
          & (jnp.max(jnp.abs(r_v), axis=(2, 3)) <= D))
    s_ui = s_u.astype(jnp.int32)
    s_vi = s_v.astype(jnp.int32)

    def body(_, x):
        ty = x["ty"]
        outs = []
        for tx in range(wn):
            su = x["su"][tx]
            sv = x["sv"][tx]
            ru = x["ru"][tx]
            rv = x["rv"][tx]
            ub = x["ub"][tx]
            vb = x["vb"][tx]

            def dense(su=su, sv=sv, ru=ru, rv=rv, tx=tx):
                blk = jax.lax.dynamic_slice(
                    Fp, (ty * th + PAD + sv - (D + 1),
                         tx * tw + PAD + su - (D + 1), jnp.int32(0)),
                    (th + 2 * (D + 1), tw + 2 * (D + 1), C))
                acc = jnp.zeros((th, tw, C), dt)
                for dy in range(-D, D + 2):
                    wy = jnp.maximum(0.0, 1.0 - jnp.abs(rv - dy))
                    for dx in range(-D, D + 2):
                        wx = jnp.maximum(0.0, 1.0 - jnp.abs(ru - dx))
                        tap = blk[D + 1 + dy : D + 1 + dy + th,
                                  D + 1 + dx : D + 1 + dx + tw]
                        acc = acc + (wx * wy)[..., None] * tap
                return acc

            def gather(ub=ub, vb=vb, tx=tx):
                # Bitwise the _bilinear_all formula, restricted to the
                # tile's global query coordinates.
                ys_g = ty * th + jnp.arange(th, dtype=jnp.int32)[:, None]
                xs_g = tx * tw + jnp.arange(tw, dtype=jnp.int32)[None, :]
                xq = xs_g + ub
                yq = ys_g + vb
                x0 = jnp.floor(xq).astype(jnp.int32)
                y0 = jnp.floor(yq).astype(jnp.int32)
                fx = (xq - x0)[..., None]
                fy = (yq - y0)[..., None]
                idx = (jnp.clip(y0, 0, h - 1) * w
                       + jnp.clip(x0, 0, w - 1))
                rows = jnp.take(packed, idx.reshape(-1),
                                axis=0).reshape(th, tw, 4 * C).astype(dt)
                s00 = rows[..., :C]
                s01 = rows[..., C:2 * C]
                s10 = rows[..., 2 * C:3 * C]
                s11 = rows[..., 3 * C:]
                return ((1 - fx) * (1 - fy) * s00 + fx * (1 - fy) * s01
                        + (1 - fx) * fy * s10 + fx * fy * s11)

            outs.append(jax.lax.cond(x["ok"][tx], dense, gather))
        return _, jnp.concatenate(outs, axis=1)  # (th, wp, C)

    xs = dict(ty=jnp.arange(hn, dtype=jnp.int32), su=s_ui, sv=s_vi,
              ok=ok, ru=r_u, rv=r_v, ub=ut, vb=vt)
    _, bands = jax.lax.scan(body, 0, xs)
    out = bands.reshape(hp, wp, C)[:h, :w]
    return [out[..., i] for i in range(C)]


def update_matrices(R1, R2, u, v, zero_flow: bool = False, packed2=None,
                    dense_warp_d: int = 0, tiled_warp: bool = False):
    """Accumulate the 5-channel normal-equation field M (OpenCV
    FarnebackUpdateMatrices): averaged A, flow-compensated db, border
    down-weighting.

    ``zero_flow=True`` is a trace-time specialization for the first
    update at a level whose flow was just initialized to zeros (the
    common case: every config with levels=1 and no initial-flow flag,
    DenseFlow.cpp:37 / FarnebackOF.cpp:24). The warp is then the
    identity, so the bilinear warps drop out entirely, as do the out-of-bounds selects and the
    A·d compensation terms.
    """
    b1_1, b2_1, a11_1, a22_1, a12_1 = R1
    h, w = u.shape
    dt = u.dtype
    xs = jnp.arange(w, dtype=dt)[None, :]
    ys = jnp.arange(h, dtype=dt)[:, None]
    if zero_flow:
        b1_2, b2_2, a11_2, a22_2, a12_2 = R2
        a11 = (a11_1 + a11_2) * 0.5
        a12 = (a12_1 + a12_2) * 0.5
        a22 = (a22_1 + a22_2) * 0.5
        db1 = (b1_1 - b1_2) * 0.5
        db2 = (b2_1 - b2_2) * 0.5
    else:
        xq = xs + u
        yq = ys + v
        inb = (xq >= 0) & (xq < w) & (yq >= 0) & (yq < h)
        if dense_warp_d > 0:
            # Runtime dispatch: the dense shift sweep is exact only
            # under the displacement bound; large motion falls to the
            # tiled pre-shift warp (exact for ANY flow, per-tile gather
            # fallback only at residual-bound violations) or, with
            # tiled_warp=False, the plain gather. One cond, both
            # branches compiled, the common small-motion frame pays no
            # gather.
            dmax = jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v)))
            if tiled_warp:
                fallback = lambda: jnp.stack(  # noqa: E731
                    _warp_tiled(R2, u, v, packed2), axis=-1)
            else:
                fallback = lambda: jnp.stack(  # noqa: E731
                    _bilinear_all(R2, xq, yq, packed=packed2), axis=-1)
            sampled = jax.lax.cond(
                dmax <= dense_warp_d,
                lambda: jnp.stack(_warp_dense(R2, u, v, dense_warp_d),
                                  axis=-1),
                fallback)
            b1_2, b2_2, a11_2, a22_2, a12_2 = (
                sampled[..., i] for i in range(5))
        else:
            b1_2, b2_2, a11_2, a22_2, a12_2 = _bilinear_all(
                R2, xq, yq, packed=packed2)

        a11 = (a11_1 + a11_2) * 0.5
        a12 = (a12_1 + a12_2) * 0.5
        a22 = (a22_1 + a22_2) * 0.5
        db1 = (b1_1 - b1_2) * 0.5
        db2 = (b2_1 - b2_2) * 0.5
        # OpenCV: where the warped point leaves the image, A is halved
        # (only frame-1 coefficients) and db is zeroed out of the average.
        a11 = jnp.where(inb, a11, a11_1 * 0.5)
        a12 = jnp.where(inb, a12, a12_1 * 0.5)
        a22 = jnp.where(inb, a22, a22_1 * 0.5)
        db1 = jnp.where(inb, db1, 0.0)
        db2 = jnp.where(inb, db2, 0.0)
        db1 = db1 + a11 * u + a12 * v
        db2 = db2 + a12 * u + a22 * v

    # Border scale: linear ramp from the image edge over _BORDER pixels.
    dist = jnp.minimum(jnp.minimum(xs, w - 1 - xs),
                       jnp.minimum(ys, h - 1 - ys))
    scale = jnp.clip((dist + 1.0) / (_BORDER + 1.0), 0.0, 1.0)
    scale = jnp.broadcast_to(scale, (h, w))
    a11, a12, a22 = a11 * scale, a12 * scale, a22 * scale
    db1, db2 = db1 * scale, db2 * scale

    m11 = a11 * a11 + a12 * a12
    m12 = a12 * (a11 + a22)
    m22 = a12 * a12 + a22 * a22
    h1 = a11 * db1 + a12 * db2
    h2 = a12 * db1 + a22 * db2
    return jnp.stack([m11, m12, m22, h1, h2], axis=0)


def _blur_same(c: jnp.ndarray, k: np.ndarray) -> jnp.ndarray:
    """Separable blur at the input size. For even kernels sep_conv2d pads k//2 on both
    sides (one extra output row/col); cropping the tail reproduces
    OpenCV's anchor-(k/2, k/2) convention (the streaming demo uses the
    even winsize 48, DenseFlow.cpp:37)."""
    h, w = c.shape
    out = sep_conv2d(c, k, k, border=bd.CLAMP)
    return out[:h, :w]


def _box_blur(M: jnp.ndarray, winsize: int) -> jnp.ndarray:
    """Mean over winsize^2 with replicate borders (OpenCV _Blur path)."""
    k = np.full(winsize, 1.0 / winsize)
    return jnp.stack([_blur_same(c, k) for c in M], axis=0)


def _gaussian_blur_m(M: jnp.ndarray, winsize: int) -> jnp.ndarray:
    sigma = winsize * 0.3
    xs = np.arange(winsize, dtype=np.float64) - (winsize - 1) / 2.0
    k = np.exp(-(xs**2) / (2 * sigma * sigma))
    k = k / k.sum()
    return jnp.stack([_blur_same(c, k) for c in M], axis=0)


def _solve_flow(M: jnp.ndarray):
    m11, m12, m22, h1, h2 = M
    det = m11 * m22 - m12 * m12
    det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
    u = (m22 * h1 - m12 * h2) / det
    v = (m11 * h2 - m12 * h1) / det
    return u, v


def _blur_solve(M: jnp.ndarray, winsize: int, gaussian: bool):
    """box/gaussian aggregate of the 5-channel M + 2x2 solve -> (u, v)."""
    blur = _gaussian_blur_m if gaussian else _box_blur
    return _solve_flow(blur(M, winsize))


@partial(jax.jit, static_argnames=("pyr_scale", "levels", "winsize",
                                   "iterations", "poly_n", "poly_sigma",
                                   "gaussian", "min_level",
                                   "dense_warp_d", "tiled_warp",
                                   "warp_table_bf16"))
def _farneback_impl(prev, nxt, u0, v0, pyr_scale, levels, winsize,
                    iterations, poly_n, poly_sigma, gaussian,
                    min_level=0, dense_warp_d=4, tiled_warp=True,
                    warp_table_bf16=False):
    """``min_level > 0`` stops the coarse-to-fine loop early and returns
    the flow at that level's resolution — the distributed path
    (tpuflow/dist/farneback.py) runs levels ``levels-1..1`` replicated
    through this exact loop, then tiles only the finest level."""
    h, w = prev.shape
    dt = prev.dtype

    u = v = None
    for k in range(levels - 1, min_level - 1, -1):
        scale = pyr_scale**k
        wl = int(round(w * scale))
        hl = int(round(h * scale))
        sigma_im = (1.0 / scale - 1.0) * 0.5
        if k == 0:
            p_l, n_l = prev, nxt
        else:
            ksz = max(int(round(sigma_im * 5)) | 1, 3)
            xs = np.arange(ksz, dtype=np.float64) - ksz // 2
            g = np.exp(-(xs**2) / (2 * sigma_im**2))
            g = g / g.sum()
            p_s = sep_conv2d(prev, g, g, border=bd.REFLECT101)
            n_s = sep_conv2d(nxt, g, g, border=bd.REFLECT101)
            p_l = jax.image.resize(p_s, (hl, wl), method="linear")
            n_l = jax.image.resize(n_s, (hl, wl), method="linear")

        zero_flow = False
        if u is None:
            if u0 is not None:
                u = jax.image.resize(u0, (hl, wl), method="linear") * scale
                v = jax.image.resize(v0, (hl, wl), method="linear") * scale
            else:
                u = jnp.zeros((hl, wl), dt)
                v = jnp.zeros((hl, wl), dt)
                zero_flow = True
        else:
            u = jax.image.resize(u, (hl, wl), method="linear") / pyr_scale
            v = jax.image.resize(v, (hl, wl), method="linear") / pyr_scale

        R1 = poly_expansion(p_l, poly_n, poly_sigma)
        R2 = poly_expansion(n_l, poly_n, poly_sigma)
        # Packed warp table: iteration-invariant, shared by every warped
        # update at this level (skipped when no update will warp).
        packed2 = None if (zero_flow and iterations <= 1) \
            else _pack_bilinear(
                R2, jnp.bfloat16 if warp_table_bf16 else None)
        M = update_matrices(R1, R2, u, v, zero_flow=zero_flow,
                            packed2=packed2, dense_warp_d=dense_warp_d,
                            tiled_warp=tiled_warp)
        for i in range(iterations):
            u, v = _blur_solve(M, winsize, gaussian)
            if i < iterations - 1:
                M = update_matrices(R1, R2, u, v, packed2=packed2,
                                    dense_warp_d=dense_warp_d,
                                    tiled_warp=tiled_warp)
    return u, v


def calc_optical_flow_farneback(
    prev,
    nxt,
    flow: tuple | None = None,
    pyr_scale: float = 0.5,
    levels: int = 3,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
    flags: int = 0,
    dense_warp_d: int = 4,
    tiled_warp: bool = True,
    warp_table_bf16: bool = False,
):
    """OpenCV-parameterized Farneback flow -> (u, v).

    flags bit 0x100 (OPTFLOW_USE_INITIAL_FLOW) uses ``flow`` as init;
    bit 0x200 (OPTFLOW_FARNEBACK_GAUSSIAN) switches the winsize
    aggregation to Gaussian weighting. ``dense_warp_d`` (default 4)
    enables the runtime-adaptive dense warp (:func:`_warp_dense`):
    frames whose current flow stays within the bound skip the
    gather entirely; 0 forces the gather path. ``tiled_warp``
    (default True) routes the LARGE-motion branch through the per-tile
    integer pre-shift warp (:func:`_warp_tiled` — slices + bounded
    dense sweep instead of a per-pixel gather, exact for arbitrary
    flow); False keeps the plain gather fallback. ``warp_table_bf16``
    (opt-in) stores the packed warp table in bfloat16 — halves the
    gathered bytes wherever a gather still runs at ~3-decimal-digit
    coefficient rounding; default f32 keeps full precision.
    """
    prev = jnp.asarray(prev)
    nxt = jnp.asarray(nxt)
    use_init = bool(flags & 0x100) and flow is not None
    u0 = jnp.asarray(flow[0], prev.dtype) if use_init else None
    v0 = jnp.asarray(flow[1], prev.dtype) if use_init else None
    gaussian = bool(flags & 0x200)
    return _farneback_impl(prev, nxt, u0, v0, float(pyr_scale), levels,
                           winsize, iterations, poly_n, float(poly_sigma),
                           gaussian,
                           dense_warp_d=int(dense_warp_d),
                           tiled_warp=bool(tiled_warp),
                           warp_table_bf16=bool(warp_table_bf16))
