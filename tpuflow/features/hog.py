"""Histograms of Oriented Gradients + brute-force HOG matching flow.

Parity with ``HOG/HOG.cpp``, ``HOG/HOG_struct.h`` and ``HOG/HOG_match.cpp``:

- :func:`orientation` — central-difference gradients (zero beyond the
  border, the PNM ``Image(x, y)`` out-of-range contract), magnitude
  ``sqrt(gx^2+gy^2)`` and the bin index from ``atan2/pi`` folded to
  [0, 1) unsigned or [0, 1) signed-rescaled (HOG.cpp:66-118);
- :func:`compute_hog` — per-cell (7x7) magnitude-weighted histograms;
  ``dense=False`` tiles the image into ``floor(W/7) x floor(H/7)`` cells
  (the reference's ``int`` division, HOG.cpp:125-131), ``dense=True``
  slides the cell per pixel (HOG.cpp:121-168);
- :func:`block_normalize` — the "dense trajectories" block normalization
  actually used by the pipeline (blocksize 3x3, distance 4x4,
  HOG.cpp:234-292): each output site stacks the 3x3 grid of histograms
  sampled ``distance`` apart, L2-normalized with eps 1e-6.
- :func:`block_normalize_integral` — the *intended* math of the 3-arg
  integral-image overload (HOG.cpp:171-232). That overload is dead code
  (the only call site, HOG.cpp:51, uses the 4-arg dense-trajectories
  version) and its output is undefined behavior, unreproducible by
  construction: (a) the integral buffer is allocated with room for rows
  of ``size.width + 1`` entries but indexed with row stride
  ``size.width`` (``integral_hist_norm[size.width * (y+1) + x+1]``,
  HOG.cpp:203/211-214), so the last column of each row aliases the first
  column two rows down; (b) ``new double[...]`` is never
  zero-initialized, and the y = 0 accumulation reads row 0 entries
  before any write (HOG.cpp:203), so every integral value inherits
  garbage. The evident intent — contiguous ``blocksize`` windows,
  L2-normalized with the same eps — is implemented here.
- :func:`hog_matching` — per-site nearest + second-nearest L2 descriptor
  search over a 65x65 window, Lowe-style score ``(d2-d1)/(d1+1e-6)``
  (HOG_match.cpp:9-75). Matches hog_prv(x) against hog_cur(x+offset), so
  the vector points forward in time from the previous frame's grid.

Design: histogram binning is a one-hot expansion fused into cell
reductions; dense cells are ``bins`` box filters; matching is a
``lax.fori_loop`` over window offsets carrying (d1, d2, best) with the
whole grid updated in parallel — no data-dependent shapes anywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

CELL = (7, 7)          # HOG.cpp:12
BLOCKSIZE = (3, 3)     # HOG.cpp:13
DISTANCE = (4, 4)      # HOG.cpp:14


@functools.partial(jax.jit, static_argnames=("bins", "signed"))
def orientation(img: jnp.ndarray, bins: int = 16, signed: bool = False):
    """(magnitude, orient) per pixel (Orientation, HOG.cpp:66-118)."""
    z = jnp.zeros_like(img)
    right = jnp.concatenate([img[:, 1:], z[:, :1]], axis=1)
    left = jnp.concatenate([z[:, :1], img[:, :-1]], axis=1)
    down = jnp.concatenate([img[1:, :], z[:1, :]], axis=0)
    up = jnp.concatenate([z[:1, :], img[:-1, :]], axis=0)
    gx = right - left
    gy = down - up
    magnitude = jnp.sqrt(gx * gx + gy * gy)
    t = jnp.arctan2(gy, gx) / jnp.pi
    if signed:
        angle = (t + 1.0) / 2.0
    else:
        angle = jnp.where(t < 0.0, 1.0 + t, t)
    orient = jnp.floor(bins * angle).astype(jnp.int32)
    orient = jnp.where(orient == bins, 0, orient)
    return magnitude, orient


@functools.partial(jax.jit, static_argnames=("bins", "cell", "dense"))
def compute_hog(magnitude: jnp.ndarray, orient: jnp.ndarray,
                bins: int = 16, cell: tuple[int, int] = CELL,
                dense: bool = False) -> jnp.ndarray:
    """(Ch, Cw, bins) cell histograms
    (ComputeHistogramsOfOrientedGradients, HOG.cpp:121-168)."""
    h, w = magnitude.shape
    cw, chh = cell
    onehot = (orient[..., None] == jnp.arange(bins)[None, None, :])
    weighted = jnp.where(onehot, magnitude[..., None], 0.0)
    if not dense:
        cells_w = w // cw
        cells_h = h // chh
        crop = weighted[: cells_h * chh, : cells_w * cw]
        return crop.reshape(cells_h, chh, cells_w, cw, bins).sum(axis=(1, 3))
    # dense: sliding (chh, cw) window sums, valid region only.
    c = jnp.cumsum(jnp.cumsum(weighted, axis=0), axis=1)
    c = jnp.pad(c, ((1, 0), (1, 0), (0, 0)))
    out = (c[chh:, cw:] - c[:-chh, cw:] - c[chh:, :-cw] + c[:-chh, :-cw])
    return out


@functools.partial(jax.jit, static_argnames=("blocksize", "distance"))
def block_normalize(hog: jnp.ndarray, blocksize: tuple[int, int] = BLOCKSIZE,
                    distance: tuple[int, int] = DISTANCE) -> jnp.ndarray:
    """Dense-trajectories block normalization (HOG.cpp:234-292).

    hog: (Ch, Cw, bins) -> (Ch - 2*my, Cw - 2*mx, bw*bh*bins) with
    margin m = (blocksize-1)/2 * distance.
    """
    bw, bh = blocksize
    dx, dy = distance
    ch, cw, bins = hog.shape
    mx = (bw - 1) // 2 * dx
    my = (bh - 1) // 2 * dy
    oh = ch - 2 * my
    ow = cw - 2 * mx
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"HOG grid {ch}x{cw} too small for block normalization "
            f"(needs > {2 * my}x{2 * mx}); use dense=True on small images")
    taps = []
    for m in range(bh):
        for n in range(bw):
            taps.append(hog[m * dy : m * dy + oh, n * dx : n * dx + ow])
    stacked = jnp.concatenate(taps, axis=-1)  # (oh, ow, bw*bh*bins)
    norm = jnp.sum(stacked * stacked, axis=-1, keepdims=True)
    coeff = 1.0 / jnp.sqrt(norm + 1.0e-12)  # + ep^2, ep = 1e-6
    return stacked * coeff


@functools.partial(jax.jit, static_argnames=("blocksize",))
def block_normalize_integral(
        hog: jnp.ndarray,
        blocksize: tuple[int, int] = BLOCKSIZE) -> jnp.ndarray:
    """Intended behavior of the dead 3-arg HOG_BlockNormalize
    (HOG.cpp:171-232; defects documented in the module docstring):
    (Ch, Cw, bins) -> (Ch - bh + 1, Cw - bw + 1, bw*bh*bins), each output
    site stacking the contiguous bh x bw histogram block, L2-normalized
    with the block's total energy + ep^2 (ep = 1e-6)."""
    bw, bh = blocksize
    ch, cw, bins = hog.shape
    oh = ch - (bh - 1)
    ow = cw - (bw - 1)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"HOG grid {ch}x{cw} smaller than block "
                         f"{bh}x{bw}")
    taps = [hog[m : m + oh, n : n + ow]
            for m in range(bh) for n in range(bw)]
    stacked = jnp.concatenate(taps, axis=-1)
    norm = jnp.sum(stacked * stacked, axis=-1, keepdims=True)
    return stacked / jnp.sqrt(norm + 1.0e-12)


def hog_descriptor(img: jnp.ndarray, bins: int = 16, signed: bool = False,
                   dense: bool = False):
    """Full pipeline: (cell_hog, normalized_block_hog)
    (HistogramsOfOrientedGradients, HOG.cpp:5-63)."""
    magnitude, orient = orientation(img, bins, signed)
    hog = compute_hog(magnitude, orient, bins, CELL, dense)
    block = block_normalize(hog, BLOCKSIZE, DISTANCE)
    return hog, block


@functools.partial(jax.jit, static_argnames=("search_w", "search_h"))
def hog_matching(feat_prv: jnp.ndarray, feat_cur: jnp.ndarray,
                 search_w: int = 65, search_h: int = 65):
    """(u, v, score) per grid site (HOG_Matching, HOG_match.cpp:9-75).

    feat_*: (H, W, D) descriptor grids. Offsets sweep
    [-search/2, search/2) (the reference's asymmetric exclusive upper
    bound); candidates leaving the grid are skipped.
    """
    h, w, d = feat_prv.shape
    dt = feat_prv.dtype
    ep = 1.0e-6
    big = jnp.asarray(1.0e10, dt)

    offs = jnp.stack(
        jnp.meshgrid(jnp.arange(-(search_h // 2), search_h // 2),
                     jnp.arange(-(search_w // 2), search_w // 2),
                     indexing="ij"), -1).reshape(-1, 2)  # (n, (yc, xc))

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]

    def body(k, carry):
        d1, d2, bx, by = carry
        yc = offs[k, 0]
        xc = offs[k, 1]
        shifted = jnp.roll(feat_cur, shift=(-yc, -xc), axis=(0, 1))
        valid = ((ys + yc >= 0) & (ys + yc < h)
                 & (xs + xc >= 0) & (xs + xc < w))
        diff = feat_prv - shifted
        dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        dist = jnp.where(valid, dist, big)
        better1 = dist < d1
        better2 = jnp.logical_and(~better1, dist < d2)
        d2 = jnp.where(better1, d1, jnp.where(better2, dist, d2))
        d1 = jnp.where(better1, dist, d1)
        bx = jnp.where(better1, xc.astype(dt), bx)
        by = jnp.where(better1, yc.astype(dt), by)
        return d1, d2, bx, by

    z = jnp.zeros((h, w), dt)
    d1, d2, bx, by = jax.lax.fori_loop(
        0, offs.shape[0], body, (jnp.full((h, w), big), jnp.full((h, w), big),
                                 z, z))
    score = (d2 - d1) / (d1 + ep)
    return bx, by, score
