"""Pyramidal Lucas-Kanade optical flow: sparse point tracking + dense field.

The reference uses OpenCV's ``calcOpticalFlowPyrLK`` with
``goodFeaturesToTrack`` seeding (``LucasKanadeOF/LucasKanadeOF.cpp:50-99``:
maxCount=500, quality=0.01, minDist=10; re-seed when <=10 tracks survive;
accept tracks with status && |dx|+|dy| > 2, lines 104-114;
``VideoFeaturesOF/FeaturesOpticalFlow.cpp:85-130`` is the same tracker in a
streaming loop). This module implements the *algorithm* (Bouguet's
pyramidal LK), not the binding:

- :func:`good_features_to_track` — Shi-Tomasi minimum-eigenvalue response
  (computed on device) + greedy min-distance suppression (host, tiny N).
- :func:`track_points` — iterative pyramidal LK, vmapped over points: per
  level, gather a fixed window by bilinear interpolation, build the 2x2
  structure tensor G = sum [Ix^2 IxIy; IxIy Iy^2] once, then Newton
  iterations d += G^-1 b with b = sum [Ix dI; Iy dI].
- :func:`dense_lucas_kanade` — dense per-pixel windowed LK via box-summed
  structure tensors (separable sums -> batched 2x2 solve), coarse-to-fine.

Design notes: point windows are static (N, win, win) gathers -> vmap maps them
to vectorized gathers; the dense variant is pure conv + pointwise algebra.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.core import borders as bd
from tpuflow.ops.filters import box_filter, sep_conv2d
from tpuflow.pyramid import pyramider


# ---------------------------------------------------------------------------
# Shi-Tomasi corners


def min_eigenvalue_response(img: jnp.ndarray, block_size: int = 3) -> jnp.ndarray:
    """Shi-Tomasi min-eigenvalue of the block-summed structure tensor."""
    d = jnp.array([-1.0, 0.0, 1.0]) * 0.5
    s = jnp.array([0.0, 1.0, 0.0])
    ix = sep_conv2d(img, d, s, border=bd.REFLECT101)
    iy = sep_conv2d(img, s, d, border=bd.REFLECT101)
    sxx = box_filter(ix * ix, block_size, border=bd.REFLECT101)
    syy = box_filter(iy * iy, block_size, border=bd.REFLECT101)
    sxy = box_filter(ix * iy, block_size, border=bd.REFLECT101)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
    return tr / 2.0 - disc


def good_features_to_track(
    img: jnp.ndarray,
    max_corners: int = 500,
    quality_level: float = 0.01,
    min_distance: float = 10.0,
    block_size: int = 3,
) -> np.ndarray:
    """OpenCV-style corner seeding; returns (N, 2) float (x, y) points."""
    resp = np.asarray(min_eigenvalue_response(img, block_size))
    thresh = quality_level * resp.max()
    # 3x3 non-max suppression.
    from scipy.ndimage import maximum_filter

    peaks = (resp == maximum_filter(resp, size=3)) & (resp > thresh)
    ys, xs = np.nonzero(peaks)
    order = np.argsort(resp[ys, xs])[::-1]
    ys, xs = ys[order], xs[order]
    # Greedy min-distance suppression on a coarse grid (OpenCV approach).
    cell = max(int(min_distance), 1)
    taken: dict[tuple[int, int], list[tuple[float, float]]] = {}
    out = []
    md2 = min_distance * min_distance
    for x, y in zip(xs, ys):
        cx, cy = x // cell, y // cell
        ok = True
        for gy in range(cy - 1, cy + 2):
            for gx in range(cx - 1, cx + 2):
                for px, py in taken.get((gx, gy), ()):
                    if (px - x) ** 2 + (py - y) ** 2 < md2:
                        ok = False
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            taken.setdefault((cx, cy), []).append((float(x), float(y)))
            out.append((float(x), float(y)))
            if len(out) >= max_corners:
                break
    return np.array(out, dtype=np.float64).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Pyramidal point tracking


def _bilinear_window(img: jnp.ndarray, cx, cy, win: int):
    """Gather a (win, win) window centered at float (cx, cy), clamped."""
    r = win // 2
    xs = cx + jnp.arange(-r, r + 1, dtype=img.dtype)
    ys = cy + jnp.arange(-r, r + 1, dtype=img.dtype)
    x0 = jnp.floor(xs).astype(jnp.int32)
    y0 = jnp.floor(ys).astype(jnp.int32)
    fx = (xs - x0)[None, :]
    fy = (ys - y0)[:, None]
    g = lambda yy, xx: bd.gather2d(img, xx[None, :], yy[:, None], bd.CLAMP)
    p00 = g(y0, x0)
    p10 = g(y0, x0 + 1)
    p01 = g(y0 + 1, x0)
    p11 = g(y0 + 1, x0 + 1)
    return ((1 - fx) * (1 - fy) * p00 + fx * (1 - fy) * p10
            + (1 - fx) * fy * p01 + fx * fy * p11)


def _lk_refine_level(prev_l, next_l, pt, guess, win, iters, eps):
    """One pyramid level of Bouguet LK for a single point."""
    px, py = pt[0], pt[1]
    # Spatial gradients of the prev window (Sobel/8, computed once).
    w_ext = win + 2
    patch = _bilinear_window(prev_l, px, py, w_ext)
    ix = (patch[1:-1, 2:] - patch[1:-1, :-2]) * 0.25 \
        + (patch[:-2, 2:] - patch[:-2, :-2]) * 0.125 \
        + (patch[2:, 2:] - patch[2:, :-2]) * 0.125
    iy = (patch[2:, 1:-1] - patch[:-2, 1:-1]) * 0.25 \
        + (patch[2:, :-2] - patch[:-2, :-2]) * 0.125 \
        + (patch[2:, 2:] - patch[:-2, 2:]) * 0.125
    tpl = patch[1:-1, 1:-1]
    gxx = jnp.sum(ix * ix)
    gxy = jnp.sum(ix * iy)
    gyy = jnp.sum(iy * iy)
    det = gxx * gyy - gxy * gxy
    ok = det > 1e-12

    def body(carry):
        d, n, done = carry
        cur = _bilinear_window(next_l, px + d[0], py + d[1], win)
        di = tpl - cur
        bx = jnp.sum(ix * di)
        by = jnp.sum(iy * di)
        dx = (gyy * bx - gxy * by) / jnp.where(ok, det, 1.0)
        dy = (gxx * by - gxy * bx) / jnp.where(ok, det, 1.0)
        d = d + jnp.where(ok, jnp.array([dx, dy]), jnp.zeros(2, d.dtype))
        done = jnp.logical_or(~ok, dx * dx + dy * dy < eps * eps)
        return d, n + 1, done

    def cond(carry):
        d, n, done = carry
        return jnp.logical_and(n < iters, jnp.logical_not(done))

    d0 = guess.astype(prev_l.dtype)
    d, _, _ = jax.lax.while_loop(cond, body,
                                 (d0, jnp.int32(0), jnp.bool_(False)))
    return d, ok


@partial(jax.jit, static_argnames=("win", "max_level", "iters"))
def _track_points_jit(prev_levels, next_levels, pts, win, max_level, iters,
                      eps):
    n_levels = max_level + 1

    def one_point(pt):
        d = jnp.zeros(2, prev_levels[0].dtype)
        ok_all = jnp.bool_(True)
        for lev in range(n_levels - 1, -1, -1):
            scale = 0.5**lev
            pt_l = pt * scale
            d, ok = _lk_refine_level(prev_levels[lev], next_levels[lev],
                                     pt_l, d, win, iters, eps)
            ok_all = jnp.logical_and(ok_all, ok)
            if lev > 0:
                d = d * 2.0
        new_pt = pt + d
        h, w = prev_levels[0].shape
        inb = ((new_pt[0] >= 0) & (new_pt[0] < w)
               & (new_pt[1] >= 0) & (new_pt[1] < h))
        return new_pt, jnp.logical_and(ok_all, inb)

    return jax.vmap(one_point)(pts)


def track_points(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    points: np.ndarray,
    win: int = 21,
    max_level: int = 3,
    iters: int = 30,
    eps: float = 0.01,
):
    """Pyramidal LK: track (N, 2) (x, y) points from prev to next.

    Returns (new_points (N, 2), status (N,) bool). Mirrors
    calcOpticalFlowPyrLK's defaults (winSize 21, maxLevel 3, 30 iters /
    0.01 eps termination).
    """
    prev_levels = pyramider(jnp.asarray(prev), max_level)
    next_levels = pyramider(jnp.asarray(next), max_level)
    pts = jnp.asarray(points, dtype=prev_levels[0].dtype)
    new_pts, status = _track_points_jit(tuple(prev_levels), tuple(next_levels),
                                        pts, win, max_level, iters, eps)
    return new_pts, status


def accept_tracked_point(old_pts, new_pts, status, min_motion: float = 2.0):
    """The demo's acceptance rule (LucasKanadeOF.cpp:104-114):
    status && |dx| + |dy| > min_motion."""
    d = jnp.abs(jnp.asarray(new_pts) - jnp.asarray(old_pts))
    return jnp.logical_and(jnp.asarray(status), d[:, 0] + d[:, 1] > min_motion)


# ---------------------------------------------------------------------------
# Dense LK


@partial(jax.jit, static_argnames=("win", "levels", "iters"))
def dense_lucas_kanade(
    prev: jnp.ndarray,
    next: jnp.ndarray,
    win: int = 15,
    levels: int = 3,
    iters: int = 3,
    eps_det: float = 1e-6,
):
    """Dense coarse-to-fine LK: per-pixel windowed 2x2 normal equations.

    Structure tensors are box sums (separable convs); the warp between
    iterations is a bilinear gather. Returns (u, v).
    """
    prev_levels = pyramider(prev, levels - 1)
    next_levels = pyramider(next, levels - 1)
    u = jnp.zeros_like(prev_levels[-1])
    v = jnp.zeros_like(prev_levels[-1])

    d = jnp.array([-1.0, 0.0, 1.0], prev.dtype) * 0.5
    s = jnp.array([0.0, 1.0, 0.0], prev.dtype)

    for lev in range(levels - 1, -1, -1):
        p_l = prev_levels[lev]
        n_l = next_levels[lev]
        h, w = p_l.shape
        if u.shape != p_l.shape:
            from tpuflow.pyramid.pyramid import upsample_nearest

            u = 2.0 * upsample_nearest(u, (h, w))
            v = 2.0 * upsample_nearest(v, (h, w))
        ix = sep_conv2d(p_l, d, s, border=bd.REFLECT101)
        iy = sep_conv2d(p_l, s, d, border=bd.REFLECT101)
        sxx = box_filter(ix * ix, win, border=bd.ZERO) * (win * win)
        sxy = box_filter(ix * iy, win, border=bd.ZERO) * (win * win)
        syy = box_filter(iy * iy, win, border=bd.ZERO) * (win * win)
        det = sxx * syy - sxy * sxy
        good = det > eps_det
        det_safe = jnp.where(good, det, 1.0)
        xs = jnp.arange(w, dtype=p_l.dtype)[None, :]
        ys = jnp.arange(h, dtype=p_l.dtype)[:, None]

        def warp(img, uu, vv):
            gx = xs + uu
            gy = ys + vv
            x0 = jnp.floor(gx).astype(jnp.int32)
            y0 = jnp.floor(gy).astype(jnp.int32)
            fx = gx - x0
            fy = gy - y0
            g = lambda yy, xx: bd.gather2d(img, xx, yy, bd.CLAMP)
            return ((1 - fx) * (1 - fy) * g(y0, x0)
                    + fx * (1 - fy) * g(y0, x0 + 1)
                    + (1 - fx) * fy * g(y0 + 1, x0)
                    + fx * fy * g(y0 + 1, x0 + 1))

        for _ in range(iters):
            it = warp(n_l, u, v) - p_l
            bx = -box_filter(ix * it, win, border=bd.ZERO) * (win * win)
            by = -box_filter(iy * it, win, border=bd.ZERO) * (win * win)
            du = (syy * bx - sxy * by) / det_safe
            dv = (sxx * by - sxy * bx) / det_safe
            u = u + jnp.where(good, du, 0.0)
            v = v + jnp.where(good, dv, 0.0)
    return u, v
