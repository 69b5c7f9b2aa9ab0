"""Block matching over regular blocks or arbitrary labeled regions.

Reconstruction of the missing ``BlockMatching<Lab>`` submodule from its
call sites (SURVEY.md §2.4; OpticalFlow_BlockMatching.cpp:96-219):

- ``reset(prev, cur[, next], block_size, subpixel)``: fixed blocks — the
  label map is the block grid (the reference builds exactly this map
  itself at OpticalFlow_BlockMatching.cpp:103-108);
- ``reset(prev, map_prev, cur, map_cur[, next, map_next], subpixel)``:
  arbitrary regions from the mean-shift segmentation;
- ``block_matching(search_range, coeff_MAD, coeff_ZNCC)``: per region,
  exhaustive displacement search over a ``search_range``-wide window with
  cost ``coeff_MAD * MAD - coeff_ZNCC * ZNCC`` (lower is better), then
  ``subpixel``-scale refinement around the integer winner;
- accessors ``get/get_prev/get_next``: per-pixel motion vector of the
  pixel's region; bidirectional ``get`` returns the better-scoring of the
  prev/next matches with the time direction t in {-1, +1}
  (Vector_ST composition, OpticalFlow_BlockMatching.cpp:307-361).

Design: regions are irregular, so the search is dense-masked — for
each candidate displacement the whole frame is shifted once, the
per-pixel Lab L1 error and ZNCC moments are reduced per region, and
``lax.map`` scans the (2R+1)^2 candidate grid. The per-region reduction
is the hot spot: instead of a scatter-based ``segment_sum``, pixels are
permuted into sorted-by-label order once (host-side argsort), and each
candidate reduces via ONE flat gather + cumsum + boundary differences,
or (the matmul methods) one one-hot matrix product per strip. No
data-dependent
shapes: the region count is static (known after host-side labeling).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


#: The integer-search evaluators ``_match_one_direction`` dispatches on.
#: Dispatch is by ``startswith("matmul")``, so an unlisted typo like
#: ``"matmul_fp16"`` would otherwise silently run the f32 evaluator (and
#: any other typo the slow gather path) — validate against this first.
METHODS = ("matmul", "matmul_bf16", "matmul_coarse", "matmul_coarse3",
           "matmul_half", "matmul_half2", "gather")


def validate_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(
            f"unknown block-matching method {method!r}; expected one of "
            f"{METHODS}")


#: Rows per one-hot strip in the matmul evaluators. Wider strips
#: amortize the halo'd block slice (core/halo row ratio 32/60 vs 8/60)
#: and the region one-hot build.
#: Both evaluators MUST share this: it fixes the partial-sum grouping,
#: which the fused-bidirectional == single-direction bitwise contract
#: depends on.
_STRIP = 32


def grid_labels(h: int, w: int, block_size: int) -> np.ndarray:
    """The reference's fixed-block domain map
    (OpticalFlow_BlockMatching.cpp:103-108)."""
    ys, xs = np.mgrid[0:h, 0:w]
    nbx = -(-w // block_size)
    return (nbx * (ys // block_size) + xs // block_size).astype(np.int32)


@dataclass
class BlockMatchResult:
    """Per-pixel motion vectors (+ per-region winners)."""

    u: np.ndarray        # (H, W) x-displacement (toward the reference frame)
    v: np.ndarray        # (H, W)
    cost: np.ndarray     # (H, W) winning cost (per pixel via its region)
    region_uv: np.ndarray    # (n_regions, 2)
    region_cost: np.ndarray  # (n_regions,)


def _shift_with_mask(img: jnp.ndarray, dx, dy):
    """img sampled at (x + dx, y + dy) with validity mask, via roll +
    out-of-bounds mask (dx, dy traced int32 scalars)."""
    h, w = img.shape[:2]
    shifted = jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    valid = ((xs + dx >= 0) & (xs + dx < w)
             & (ys + dy >= 0) & (ys + dy < h))
    return shifted, valid


def region_reduction_plan(labels: np.ndarray, n_regions: int):
    """Host-side precomputation for fast per-region sums: the
    sort-by-label pixel permutation and the region boundary offsets."""
    flat = np.asarray(labels).reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=n_regions)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return perm, bounds


def region_bucket(n_regions: int, minimum: int = 128) -> int:
    """Round a region count up to the next bucket 128 * (2^k or 3*2^k):
    128, 256, 384, 512, 768, 1024, 1536, 2048, ...

    The jitted matchers take the region count as a static argument;
    mean-shift region counts drift from frame to frame, and every fresh
    count would recompile the whole search. Bucketing pads the
    per-region arrays to a stable size: padded regions are empty ranges
    whose cost is +inf, and callers slice the outputs back to the true
    count — results are bucket-independent.

    The ladder is 1-2-3 x 2^k (consecutive ratio <= 1.5 from 256 up —
    the bottom 128->256 rung is 2x; average padding ~20%): a real frame
    sequence drifts across many every-128 buckets, and each fresh
    bucket compiles again, while the padding itself is cheap."""
    n = max(int(minimum), int(n_regions))
    m = -(-n // 128)
    best = None
    for base in (1, 3):
        k = 0
        while (base << k) < m:
            k += 1
        cand = base << k
        if cand >= m and (best is None or cand < best):
            best = cand
    return 128 * best


def pad_region_bounds(bounds: np.ndarray, n_pad: int) -> np.ndarray:
    """Extend a (n_regions + 1,) bounds array to (n_pad + 1,) by
    repeating the final offset — the appended regions are empty."""
    n_regions = bounds.shape[0] - 1
    if n_pad == n_regions:
        return bounds
    return np.concatenate(
        [bounds, np.full(n_pad - n_regions, bounds[-1], bounds.dtype)])


def _contiguous_range_sums(sorted_fields: jnp.ndarray,
                           bounds: jnp.ndarray,
                           chunk: int = 512) -> jnp.ndarray:
    """Per-range sums S[bounds[r]:bounds[r+1]] of a (N, C) array in ~2
    data passes: chunk partial sums + tiny cumsum + masked boundary-chunk
    prefixes, instead of a full O(log N)-pass cumsum."""
    n, c = sorted_fields.shape
    n_pad = -(-n // chunk) * chunk
    f = jnp.pad(sorted_fields, ((0, n_pad - n), (0, 0)))
    chunks = f.reshape(n_pad // chunk, chunk, c)
    partial = chunks.sum(axis=1)                       # (n_chunks, C)
    cs = jnp.concatenate(
        [jnp.zeros((1, c), f.dtype), jnp.cumsum(partial, axis=0)], axis=0)
    cidx = bounds // chunk                             # (n_bounds,)
    off = bounds % chunk
    rows = jnp.take(chunks, jnp.minimum(cidx, chunks.shape[0] - 1), axis=0)
    mask = (jnp.arange(chunk)[None, :] < off[:, None]).astype(f.dtype)
    prefix = (rows * mask[:, :, None]).sum(axis=1)     # (n_bounds, C)
    s_at = jnp.take(cs, cidx, axis=0) + prefix         # (n_bounds, C)
    return s_at[1:] - s_at[:-1]


#: MAD is reported in STANDARD CIE-Lab units (L in [0, 100]) — the
#: missing ImgClass ``Lab`` the reference matches in is standard-scale,
#: so coeff_MAD=1.0 / coeff_ZNCC=0.5 (OpticalFlow_BlockMatching.cpp:219)
#: balances an O(1-20) MAD against a [-1, 1] ZNCC tiebreak. tpuflow's
#: normalized Lab (core/color.py, /100) made MAD ~100x too small, so the
#: cost degenerated to pure ZNCC — measured 1.4 dB of motion-compensation
#: PSNR on the KITTI quality crop. The matcher un-normalizes internally.
from tpuflow.core.color import LAB_SCALE as _LAB_SCALE  # noqa: E402


def _moment_fields(cur: jnp.ndarray, ref_shifted: jnp.ndarray,
                   member: jnp.ndarray) -> jnp.ndarray:
    """(N, 7) per-pixel moment fields for the MAD+ZNCC cost.

    ``member`` masks pixels that exist in the matching domain (the
    strip-grid padding rows); out-of-FRAME reference reads are NOT
    masked — they arrive as zeros (the reference's ``get_zeropad``
    border convention, e.g. OpticalFlow.cpp:181-187), so a displacement
    pushing a region outside the frame pays |cur - 0| in the MAD.
    Masked-mean costs (the previous convention) carried a selection
    bias toward few-valid-pixel displacements that measured 5.3 dB of
    compensation PSNR on the KITTI quality crop."""
    m = member.astype(cur.dtype)
    lab_l1 = jnp.sum(jnp.abs(cur - ref_shifted), axis=-1) * (_LAB_SCALE / 3.0)
    a = cur[..., 0]
    b = ref_shifted[..., 0]
    return jnp.stack(
        [m, m * lab_l1, m * a, m * b, m * a * a, m * b * b, m * a * b],
        axis=-1).reshape(-1, 7)


def _cost_core(n, s_mad, s_a, s_b, s_aa, s_bb, s_ab, dtype):
    """Moment sums (broadcastable) -> (mad, zncc, n)."""
    n_safe = jnp.maximum(n, 1.0)
    mad = s_mad / n_safe
    sa = s_a / n_safe
    sb = s_b / n_safe
    saa = s_aa / n_safe
    sbb = s_bb / n_safe
    sab = s_ab / n_safe
    var_a = jnp.maximum(saa - sa * sa, 0.0)
    var_b = jnp.maximum(sbb - sb * sb, 0.0)
    denom = jnp.sqrt(var_a * var_b) + 1e-12
    # Cauchy-Schwarz bounds the true ZNCC to [-1, 1]; the f32 moment
    # form loses that on near-constant regions (saa - sa*sa cancels to
    # rounding noise ~1e-8 over a ~1e-12 denominator), which produced
    # |zncc| in the THOUSANDS and let flat regions out-vote the MAD
    # term with garbage matches (measured: a 1504-px region at cost
    # -3356 picking a search-corner displacement). Clamping restores
    # the exact-math bound; well-conditioned regions are unaffected.
    zncc = jnp.clip((sab - sa * sb) / denom, -1.0, 1.0)
    big = jnp.asarray(jnp.inf, dtype)
    return jnp.where(jnp.broadcast_to(n > 0, mad.shape), mad, big), zncc, n


def _cost_from_sums(sums: jnp.ndarray, dtype):
    """(..., n_regions, 7) moment sums -> (mad, zncc, n)."""
    return _cost_core(sums[..., 0], sums[..., 1], sums[..., 2],
                      sums[..., 3], sums[..., 4], sums[..., 5],
                      sums[..., 6], dtype)


def _region_costs(cur: jnp.ndarray, ref_shifted: jnp.ndarray,
                  valid: jnp.ndarray, perm: jnp.ndarray,
                  bounds: jnp.ndarray, n_regions: int):
    """cost_r = coeff_MAD * MAD_r - coeff_ZNCC * ZNCC_r for one candidate.

    MAD over mean Lab L1 distance (standard Lab units); ZNCC over the L
    channel. Out-of-frame matches compare against zeros (``valid``
    zeroes the roll's wrapped values — get_zeropad semantics). All seven
    moment fields reduce with one permuted gather + cumsum + boundary
    differences instead of segment_sum's scatters.
    """
    ref_zp = ref_shifted * valid.astype(cur.dtype)[..., None]
    fields = _moment_fields(cur, ref_zp, jnp.ones(cur.shape[:2], cur.dtype))
    sorted_fields = jnp.take(fields, perm, axis=0)
    sums = _contiguous_range_sums(sorted_fields, bounds)
    return _cost_from_sums(sums, cur.dtype)


def search_candidates(search_range: int) -> np.ndarray:
    """The (2R+1)^2 integer displacement grid, (n, (dy, dx)), in the
    canonical (row-major over dy then dx) order every matcher variant
    shares — the distributed candidate-parallel path depends on it."""
    R = search_range // 2
    return np.stack(
        np.meshgrid(np.arange(-R, R + 1), np.arange(-R, R + 1),
                    indexing="ij"), -1).reshape(-1, 2)


def _padded_candidates(search_range: int, chunk: int, n_shards: int = 1):
    """The (2R+1)^2 grid padded so each of ``n_shards`` devices holds a
    chunk-multiple slice ((0, 0) fillers, discarded after scoring).
    Returns the padded (n_padded, 2) device array — the one copy of the
    padding arithmetic shared by the single-device and
    candidate-parallel matchers (the scoring tail rederives the true
    candidate count from search_range itself)."""
    cand_np = search_candidates(search_range)
    n_cand = cand_np.shape[0]
    per = -(-n_cand // n_shards)
    per = -(-per // chunk) * chunk
    pad = per * n_shards - n_cand
    return jnp.asarray(
        np.concatenate([cand_np, np.zeros((pad, 2), cand_np.dtype)]))


def _binomial3(img: jnp.ndarray) -> jnp.ndarray:
    """Separable (1/4, 1/2, 1/4) low-pass with edge-clamped borders —
    the anti-alias prefilter before the half-res subsample. Strict
    stride-2 subsampling aliases high-frequency texture into the
    quarter-sample MAD/ZNCC estimates and measurably degrades the
    coarse argmin (corpus: -0.36 dB strict vs -0.07 full-res stride-2,
    r5 ablation); the classic pyramid prefilter restores cost
    fidelity. Static shift-adds — never lax.conv (pathological on this
    chip)."""
    p = jnp.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    r = 0.25 * p[:-2] + 0.5 * p[1:-1] + 0.25 * p[2:]
    return 0.25 * r[:, :-2] + 0.5 * r[:, 1:-1] + 0.25 * r[:, 2:]


def _half_res(img: jnp.ndarray) -> jnp.ndarray:
    """Anti-aliased half-resolution view of a (H, W, C) frame."""
    return _binomial3(img)[::2, ::2]


def coarse_candidates(search_range: int, stride: int = 2) -> np.ndarray:
    """The stride-``stride`` subgrid of :func:`search_candidates` (dy
    and dx both multiples of the stride, (0, 0) included) — ~1/stride^2
    of the (2R+1)^2 grid. The ``"matmul_coarse"`` (stride 2) and
    ``"matmul_coarse3"`` (stride 3) methods sweep these, then recover
    the skipped cells with an inclusive +-1-px local refinement around
    the coarse winner (:func:`_local_refine`; every integer lies within
    1 of a stride-<=3 grid point, so the refinement covers the lattice
    exactly — the heuristic risk is the coarse argmin picking a cell
    away from the true winner's neighborhood)."""
    cand = search_candidates(search_range)
    keep = (cand[:, 0] % stride == 0) & (cand[:, 1] % stride == 0)
    return cand[keep]


def _coarse_padded_candidates(search_range: int, chunk: int,
                              stride: int = 2, n_shards: int = 1):
    """Coarse twin of :func:`_padded_candidates`: the stride-subgrid
    padded so each of ``n_shards`` devices holds a chunk-multiple slice
    ((0, 0) fillers, discarded after scoring)."""
    cand = coarse_candidates(search_range, stride)
    per = -(-len(cand) // n_shards)
    per = -(-per // chunk) * chunk
    pad = per * n_shards - len(cand)
    return (jnp.asarray(np.concatenate(
        [cand, np.zeros((pad, 2), cand.dtype)])), len(cand))


def _coarse_argmin_and_refine(costs, cur_lab, ref_lab, labels, perm,
                              bounds, n_regions: int, search_range: int,
                              subpixel_scale: int, coeff_mad: float,
                              coeff_zncc: float, stride: int = 2,
                              refine_radius: int = 1):
    """Scoring tail of the ``"matmul_coarse"`` method: argmin over the
    stride-2 grid, then ONE inclusive [-r, +r]^2 local refinement at
    1/subpixel steps (:func:`_local_refine`) that recovers the skipped
    odd integer cells AND subsumes the subpixel stage. Not bitwise with
    the exhaustive search: a distant coarse cell can out-score the true
    winner's even neighbors (quality-guarded by a corpus sweep).
    ``refine_radius=2`` (the ``"matmul_half2"`` method) widens the
    refinement to the winner's even-cell neighbors too,
    hedging argmin errors from quarter-resolution scoring."""
    dt = cur_lab.dtype
    cand_full = jnp.asarray(coarse_candidates(search_range, stride))
    costs = costs[: cand_full.shape[0]]
    best = jnp.argmin(costs, axis=0)
    best_cost = jnp.take_along_axis(costs, best[None, :], axis=0)[0]
    best_d = cand_full[best].astype(dt)
    # A region the coarse pass never scored (every candidate inf — e.g.
    # a region with no pixel on the half-res sample grid under
    # "matmul_half") would otherwise seed the refinement at the grid
    # corner cand[0] = (-R, -R); re-seed it at zero displacement (the
    # refinement then scores the true full-res costs around it).
    best_d = jnp.where(jnp.isfinite(best_cost)[:, None], best_d, 0.0)
    best_d, best_cost = _local_refine(
        cur_lab, ref_lab, labels, perm, bounds, n_regions, best_d,
        best_cost, max(subpixel_scale, 1), refine_radius, coeff_mad,
        coeff_zncc)
    uv = jnp.stack([best_d[:, 1], best_d[:, 0]], axis=-1)
    return uv, best_cost


def _argmin_and_refine(costs, cur_lab, ref_lab, labels, perm, bounds,
                       n_regions: int, search_range: int,
                       subpixel_scale: int, coeff_mad: float,
                       coeff_zncc: float):
    """Integer argmin over a (possibly padding-trailed) cost table +
    subpixel refinement for ONE direction -> (uv, cost). The one copy of
    the scoring tail shared by every matcher variant (the fused ==
    single-direction and sharded == single-device bitwise contracts
    ride on it)."""
    dt = cur_lab.dtype
    cand_full = jnp.asarray(search_candidates(search_range))
    costs = costs[: cand_full.shape[0]]
    best = jnp.argmin(costs, axis=0)
    best_cost = jnp.take_along_axis(costs, best[None, :], axis=0)[0]
    best_d = cand_full[best].astype(dt)
    if subpixel_scale > 1:
        best_d, best_cost = _subpixel_refine(
            cur_lab, ref_lab, labels, perm, bounds, n_regions, best_d,
            best_cost, subpixel_scale, coeff_mad, coeff_zncc)
    uv = jnp.stack([best_d[:, 1], best_d[:, 0]], axis=-1)
    return uv, best_cost


def _integer_costs(cur_lab, ref_lab, perm, bounds, n_regions: int,
                   cand, coeff_mad: float, coeff_zncc: float, chunk: int):
    """MAD+ZNCC cost of every candidate displacement, (n_cand_padded,
    n_regions); ``cand`` length must be a multiple of ``chunk``."""
    dt = cur_lab.dtype
    CH = chunk
    n_pix = cur_lab.shape[0] * cur_lab.shape[1]

    ones = jnp.ones(cur_lab.shape[:2], dt)

    def eval_chunk(d_chunk):
        # One permuted gather serves CH candidates: the gather is the
        # dominant cost, and (CH*7)-float rows amortize it.
        def fields_for(d):
            shifted, valid = _shift_with_mask(ref_lab, d[1], d[0])
            return _moment_fields(
                cur_lab, shifted * valid.astype(dt)[..., None], ones)

        f = jax.vmap(fields_for)(d_chunk)            # (CH, N, 7)
        f = jnp.transpose(f, (1, 0, 2)).reshape(n_pix, CH * 7)
        fs = jnp.take(f, perm, axis=0)
        sums = _contiguous_range_sums(fs, bounds)    # (n_regions, CH*7)
        sums = jnp.transpose(
            sums.reshape(n_regions, CH, 7), (1, 0, 2))  # (CH, n_regions, 7)
        mad, zncc, _ = _cost_from_sums(sums, dt)
        return coeff_mad * mad - coeff_zncc * zncc   # (CH, n_regions)

    chunks = cand.reshape(-1, CH, 2)
    return jax.lax.map(eval_chunk, chunks).reshape(-1, n_regions)


def _integer_costs_matmul(cur_lab, ref_lab, labels, n_regions: int,
                          cand, coeff_mad: float, coeff_zncc: float,
                          chunk: int, radius: int, dot_dtype=None):
    """Gather-free integer search: per ``_STRIP``-row strip, the region
    one-hot matrix L (strip_pixels, n_regions) is built once and every
    candidate chunk reduces through ONE matrix product ``L^T @ fields``
    instead of the permuted-gather + cumsum pass. The shifted reference
    is a cheap ``dynamic_slice`` of a padded copy (contiguous copy, not a
    gather). Every product runs at HIGHEST precision: the moment-form
    ZNCC does not survive TF32 products.

    Same contract as :func:`_integer_costs`: (n_cand_padded, n_regions)
    costs; ``cand`` length must be a multiple of ``chunk``; ``radius``
    bounds ``max |d|`` (the reference pad margin).

    ``dot_dtype`` (e.g. ``jnp.bfloat16``) feeds the one-hot product at a
    reduced input precision with f32 accumulation. The one-hot L is
    exact in bf16; only the (already f32-computed) moment fields are
    rounded on entry, so region sums keep f32 carry error ~0.4%/sqrt(N)
    — winners agree with the f32 evaluator except at near-ties (which
    the subpixel stage re-scores in f32 anyway)."""
    dt = cur_lab.dtype
    CH = chunk
    R = radius
    STRIP = _STRIP
    h, w = cur_lab.shape[:2]
    n_ch_col = cur_lab.shape[-1]
    hp = _host_cdiv(h, STRIP) * STRIP
    n_s = hp // STRIP
    P = STRIP * w
    cur_p = jnp.pad(cur_lab, ((0, hp - h), (0, 0), (0, 0)))
    inside = jnp.pad(jnp.ones((h, w), dt), ((0, hp - h), (0, 0)))
    lab_p = jnp.pad(labels, ((0, hp - h), (0, 0)))
    # Row pad to hp + 2R so the strip block slice never clamps; clamped
    # starts would misalign the last strip's real rows.
    ref_p = jnp.pad(ref_lab, ((R, R + hp - h), (R, R), (0, 0)))
    chunks = cand.reshape(-1, CH, 2)
    n_chunks = chunks.shape[0]
    reg_ids = jnp.arange(n_regions, dtype=jnp.int32)[None, :]

    def per_strip(acc, s):
        y0 = s * STRIP
        lab_s = jax.lax.dynamic_slice(lab_p, (y0, 0), (STRIP, w))
        L = (lab_s.reshape(P)[:, None] == reg_ids).astype(dt)
        cur_s = jax.lax.dynamic_slice(
            cur_p, (y0, 0, 0), (STRIP, w, n_ch_col)).reshape(P, n_ch_col)
        ins_s = jax.lax.dynamic_slice(inside, (y0, 0), (STRIP, w))
        block = jax.lax.dynamic_slice(
            ref_p, (y0, 0, 0), (STRIP + 2 * R, w + 2 * R, n_ch_col))
        m = ins_s.reshape(P)
        a = cur_s[..., 0]
        ma = m * a
        # With get_zeropad reads the cur-side moments (n, a-sums) are
        # CANDIDATE-INVARIANT: one tiny f32 matmul per strip replaces
        # 3 of the 7 per-candidate channels.
        fix_f = jnp.stack([m, ma, ma * a], axis=-1)      # (P, 3)
        fix_local = jax.lax.dot_general(  # (n_regions, 3)
            L, fix_f, (((0,), (0,)), ((), ())),
            precision=_HIGHEST, preferred_element_type=dt)

        def fields_for(d):
            dy, dx = d[0], d[1]
            # ref_p is zero-padded, so out-of-frame reads arrive as
            # zeros (get_zeropad); membership masks only the strip-grid
            # padding rows.
            sub = jax.lax.dynamic_slice(
                block, (R + dy, R + dx, 0),
                (STRIP, w, n_ch_col)).reshape(P, n_ch_col)
            l1 = jnp.sum(jnp.abs(cur_s - sub), axis=-1) * (_LAB_SCALE / 3.0)
            b = sub[..., 0]
            mb = m * b
            return jnp.stack([m * l1, mb, mb * b, ma * b], axis=-1)

        def per_chunk(d_chunk):
            F = jax.vmap(fields_for)(d_chunk)            # (CH, P, 4)
            if dot_dtype is None:
                # Contract P directly against the (CH, P, 4) array: the
                # operand fetch folds the relayout an explicit
                # (P, CH*4) transpose would make a separate pass.
                out = jax.lax.dot_general(  # (n_regions, CH, 4)
                    L, F, (((0,), (1,)), ((), ())),
                    precision=_HIGHEST, preferred_element_type=dt)
                return out.reshape(n_regions, CH * 4)
            # The reduced-precision product takes the rank-2 form: the
            # CPU backend has no rank-3 BF16 x BF16 = F32 dot.
            F2 = jnp.transpose(F, (1, 0, 2)).reshape(P, CH * 4)
            return jax.lax.dot_general(  # (n_regions, CH*4)
                L.astype(dot_dtype), F2.astype(dot_dtype),
                (((0,), (0,)), ((), ())),
                precision=_HIGHEST, preferred_element_type=dt)

        acc_var, acc_fix = acc
        return (acc_var + jax.lax.map(per_chunk, chunks),
                acc_fix + fix_local), None

    acc0 = (jnp.zeros((n_chunks, n_regions, CH * 4), dt),
            jnp.zeros((n_regions, 3), dt))
    (acc_var, acc_fix), _ = jax.lax.scan(per_strip, acc0, jnp.arange(n_s))
    var = jnp.transpose(
        acc_var.reshape(n_chunks, n_regions, CH, 4),
        (0, 2, 1, 3)).reshape(-1, n_regions, 4)
    mad, zncc, _ = _cost_core(acc_fix[:, 0], var[..., 0], acc_fix[:, 1],
                              var[..., 1], acc_fix[:, 2], var[..., 2],
                              var[..., 3], dt)
    return coeff_mad * mad - coeff_zncc * zncc


def _integer_costs_matmul_bidi(cur_lab, refp_lab, refn_lab, labels,
                               n_regions: int, cand, coeff_mad: float,
                               coeff_zncc: float, chunk: int, radius: int,
                               dot_dtype=None):
    """Both time directions of :func:`_integer_costs_matmul` in ONE
    evaluator. The bidirectional flagship match evaluates prev and next
    against the SAME current frame and labels, so the candidate-invariant
    cur-side moments reduce once per strip and the per-candidate build is
    8 shared-structure channels instead of 2x7 — cutting the field build
    (the evaluator's measured bound at KITTI-res region counts) and
    halving the slices, one-hot builds and matmul launches.

    Per-channel sums are the same dot products in the same order as the
    single-direction evaluator, so each direction's costs are
    bitwise-equal to a :func:`_integer_costs_matmul` call
    (tests/test_bm_flow.py pins this). Returns (costs_prev, costs_next),
    each (n_cand_padded, n_regions)."""
    dt = cur_lab.dtype
    CH = chunk
    R = radius
    STRIP = _STRIP
    h, w = cur_lab.shape[:2]
    n_ch_col = cur_lab.shape[-1]
    hp = _host_cdiv(h, STRIP) * STRIP
    n_s = hp // STRIP
    P = STRIP * w
    cur_p = jnp.pad(cur_lab, ((0, hp - h), (0, 0), (0, 0)))
    inside = jnp.pad(jnp.ones((h, w), dt), ((0, hp - h), (0, 0)))
    lab_p = jnp.pad(labels, ((0, hp - h), (0, 0)))
    refp_pad = jnp.pad(refp_lab, ((R, R + hp - h), (R, R), (0, 0)))
    refn_pad = jnp.pad(refn_lab, ((R, R + hp - h), (R, R), (0, 0)))
    chunks = cand.reshape(-1, CH, 2)
    n_chunks = chunks.shape[0]
    reg_ids = jnp.arange(n_regions, dtype=jnp.int32)[None, :]

    def per_strip(acc, s):
        y0 = s * STRIP
        lab_s = jax.lax.dynamic_slice(lab_p, (y0, 0), (STRIP, w))
        L = (lab_s.reshape(P)[:, None] == reg_ids).astype(dt)
        cur_s = jax.lax.dynamic_slice(
            cur_p, (y0, 0, 0), (STRIP, w, n_ch_col)).reshape(P, n_ch_col)
        ins_s = jax.lax.dynamic_slice(inside, (y0, 0), (STRIP, w))
        block_p = jax.lax.dynamic_slice(
            refp_pad, (y0, 0, 0), (STRIP + 2 * R, w + 2 * R, n_ch_col))
        block_n = jax.lax.dynamic_slice(
            refn_pad, (y0, 0, 0), (STRIP + 2 * R, w + 2 * R, n_ch_col))
        m = ins_s.reshape(P)
        a = cur_s[..., 0]
        ma = m * a
        # Candidate-invariant cur-side moments, shared by BOTH
        # directions: one tiny f32 matmul per strip (same expressions
        # as the single-direction evaluator — bitwise contract).
        fix_f = jnp.stack([m, ma, ma * a], axis=-1)      # (P, 3)
        fix_local = jax.lax.dot_general(  # (n_regions, 3)
            L, fix_f, (((0,), (0,)), ((), ())),
            precision=_HIGHEST, preferred_element_type=dt)

        def fields_for(d):
            dy, dx = d[0], d[1]
            # Zero-padded reference buffers: out-of-frame reads arrive
            # as zeros (get_zeropad).
            sub_p = jax.lax.dynamic_slice(
                block_p, (R + dy, R + dx, 0),
                (STRIP, w, n_ch_col)).reshape(P, n_ch_col)
            sub_n = jax.lax.dynamic_slice(
                block_n, (R + dy, R + dx, 0),
                (STRIP, w, n_ch_col)).reshape(P, n_ch_col)
            l1_p = jnp.sum(jnp.abs(cur_s - sub_p),
                           axis=-1) * (_LAB_SCALE / 3.0)
            l1_n = jnp.sum(jnp.abs(cur_s - sub_n),
                           axis=-1) * (_LAB_SCALE / 3.0)
            bp = sub_p[..., 0]
            bn = sub_n[..., 0]
            mbp = m * bp
            mbn = m * bn
            return jnp.stack(
                [m * l1_p, mbp, mbp * bp, ma * bp,
                 m * l1_n, mbn, mbn * bn, ma * bn], axis=-1)  # (P, 8)

        def per_chunk(d_chunk):
            F = jax.vmap(fields_for)(d_chunk)            # (CH, P, 8)
            if dot_dtype is None:
                out = jax.lax.dot_general(  # (n_regions, CH, 8)
                    L, F, (((0,), (1,)), ((), ())),
                    precision=_HIGHEST, preferred_element_type=dt)
                return out.reshape(n_regions, CH * 8)
            F2 = jnp.transpose(F, (1, 0, 2)).reshape(P, CH * 8)
            return jax.lax.dot_general(  # (n_regions, CH*8)
                L.astype(dot_dtype), F2.astype(dot_dtype),
                (((0,), (0,)), ((), ())),
                precision=_HIGHEST, preferred_element_type=dt)

        acc_var, acc_fix = acc
        return (acc_var + jax.lax.map(per_chunk, chunks),
                acc_fix + fix_local), None

    acc0 = (jnp.zeros((n_chunks, n_regions, CH * 8), dt),
            jnp.zeros((n_regions, 3), dt))
    (acc_var, acc_fix), _ = jax.lax.scan(per_strip, acc0, jnp.arange(n_s))
    var = jnp.transpose(
        acc_var.reshape(n_chunks, n_regions, CH, 8),
        (0, 2, 1, 3)).reshape(-1, n_regions, 8)
    out = []
    for off in (0, 4):
        mad, zncc, _ = _cost_core(
            acc_fix[:, 0], var[..., off + 0], acc_fix[:, 1],
            var[..., off + 1], acc_fix[:, 2], var[..., off + 2],
            var[..., off + 3], dt)
        out.append(coeff_mad * mad - coeff_zncc * zncc)
    return tuple(out)


def _host_cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _subpixel_refine(cur_lab, ref_lab, labels, perm, bounds,
                     n_regions: int, best_d, best_cost,
                     subpixel_scale: int, coeff_mad: float,
                     coeff_zncc: float):
    dt = cur_lab.dtype
    n_pix = cur_lab.shape[0] * cur_lab.shape[1]
    # Refine around the integer winner on a 1/subpixel grid. Every
    # subpixel offset is a fraction in (-1, 1) around the *integer*
    # winner, so all candidates' bilinear taps live in the same 3x3
    # integer neighborhood: gather it ONCE (9 flat row-gathers shared
    # by every candidate), build every candidate's moment fields, and
    # reduce them all with a single permuted gather + range-sum pass
    # — the same candidate-chunked scheme as the integer search
    # (one gather/cumsum per candidate dominated this stage before).
    s = 1.0 / subpixel_scale
    sub_np = np.stack(
        np.meshgrid(np.arange(-(subpixel_scale - 1), subpixel_scale),
                    np.arange(-(subpixel_scale - 1), subpixel_scale),
                    indexing="ij"), -1).reshape(-1, 2) * s  # (n_sub, 2)
    n_sub = sub_np.shape[0]
    h, w = cur_lab.shape[:2]
    xs_i = jnp.arange(w, dtype=jnp.int32)[None, :]
    ys_i = jnp.arange(h, dtype=jnp.int32)[:, None]
    d_pix = best_d[labels]  # (H, W, (dy, dx)) integer-valued
    # Taps are gathered DIRECTLY in region-sorted order (base indices
    # permuted first): permutation commutes with every pointwise step
    # below, so the range sums are bitwise the raster-order formulation
    # while the (N, n_sub*7)-wide permuted reduction it needed
    # (~120 MB of gathered bytes per direction at KITTI res on the
    # ~2.6 GB/s gather unit) disappears (r4).
    x_base = jnp.take(
        (xs_i + d_pix[..., 1].astype(jnp.int32)).reshape(-1), perm)
    y_base = jnp.take(
        (ys_i + d_pix[..., 0].astype(jnp.int32)).reshape(-1), perm)
    ref_flat = ref_lab.reshape(h * w, -1)
    cur_s = jnp.take(cur_lab.reshape(n_pix, -1), perm, axis=0)

    ones = jnp.ones((n_pix,), dt)

    def g(yy, xx):
        # Zero-pad taps (get_zeropad): out-of-frame reads contribute 0
        # to the bilinear interpolation, matching the integer search.
        ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).astype(dt)
        yy = jnp.clip(yy, 0, h - 1)
        xx = jnp.clip(xx, 0, w - 1)
        return jnp.take(ref_flat, yy * w + xx, axis=0) * ok[..., None]

    nb = {(jy, jx): g(y_base + jy, x_base + jx)
          for jy in (-1, 0, 1) for jx in (-1, 0, 1)}  # (N, C), sorted

    fields_all = []
    for dy_f, dx_f in sub_np:
        iy = int(np.floor(dy_f))  # -1 or 0
        ix = int(np.floor(dx_f))
        fx = float(dx_f - ix)
        fy = float(dy_f - iy)
        interp = ((1 - fx) * (1 - fy) * nb[(iy, ix)]
                  + fx * (1 - fy) * nb[(iy, ix + 1)]
                  + (1 - fx) * fy * nb[(iy + 1, ix)]
                  + fx * fy * nb[(iy + 1, ix + 1)])
        fields_all.append(_moment_fields(cur_s, interp, ones))
    fs = jnp.stack(fields_all, axis=1).reshape(n_pix, n_sub * 7)
    sums = _contiguous_range_sums(fs, bounds)      # (n_regions, n_sub*7)
    sums = jnp.transpose(
        sums.reshape(n_regions, n_sub, 7), (1, 0, 2))
    mad, zncc, _ = _cost_from_sums(sums, dt)
    sub_costs = coeff_mad * mad - coeff_zncc * zncc  # (n_sub, n_regions)
    sbest = jnp.argmin(sub_costs, axis=0)
    best_cost = jnp.take_along_axis(sub_costs, sbest[None, :], axis=0)[0]
    best_d = best_d + jnp.asarray(sub_np, dt)[sbest]
    return best_d, best_cost


def _local_refine(cur_lab, ref_lab, labels, perm, bounds,
                  n_regions: int, best_d, best_cost,
                  subpixel_scale: int, radius: int,
                  coeff_mad: float, coeff_zncc: float):
    """Inclusive [-radius, +radius]^2 refinement at 1/subpixel steps
    around the per-region integer winner — :func:`_subpixel_refine`'s
    shared-neighborhood scheme (all candidates' bilinear taps come from
    one (2*radius+2)^2 tap gather) extended to integer radii, for the
    coarse search's odd-cell recovery. Kept SEPARATE from
    _subpixel_refine: that function's exclusive (-1, 1) grid and 3x3
    taps are a bitwise contract of the exhaustive methods."""
    dt = cur_lab.dtype
    n_pix = cur_lab.shape[0] * cur_lab.shape[1]
    s = 1.0 / subpixel_scale
    steps = np.arange(-radius * subpixel_scale,
                      radius * subpixel_scale + 1) * s
    sub_np = np.stack(np.meshgrid(steps, steps, indexing="ij"),
                      -1).reshape(-1, 2)  # (n_sub, 2), inclusive
    n_sub = sub_np.shape[0]
    h, w = cur_lab.shape[:2]
    xs_i = jnp.arange(w, dtype=jnp.int32)[None, :]
    ys_i = jnp.arange(h, dtype=jnp.int32)[:, None]
    d_pix = best_d[labels]
    # Sorted-order tap gathers, as in _subpixel_refine (r4): the wide
    # permuted reduction drops out; values are permutation-identical.
    x_base = jnp.take(
        (xs_i + d_pix[..., 1].astype(jnp.int32)).reshape(-1), perm)
    y_base = jnp.take(
        (ys_i + d_pix[..., 0].astype(jnp.int32)).reshape(-1), perm)
    ref_flat = ref_lab.reshape(h * w, -1)
    cur_s = jnp.take(cur_lab.reshape(n_pix, -1), perm, axis=0)

    ones = jnp.ones((n_pix,), dt)

    def g(yy, xx):
        # Zero-pad taps (get_zeropad), as in _subpixel_refine.
        ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).astype(dt)
        yy = jnp.clip(yy, 0, h - 1)
        xx = jnp.clip(xx, 0, w - 1)
        return jnp.take(ref_flat, yy * w + xx, axis=0) * ok[..., None]

    taps = range(-radius, radius + 2)
    nb = {(jy, jx): g(y_base + jy, x_base + jx)
          for jy in taps for jx in taps}

    fields_all = []
    for dy_f, dx_f in sub_np:
        iy = int(np.floor(dy_f))
        ix = int(np.floor(dx_f))
        fx = float(dx_f - ix)
        fy = float(dy_f - iy)
        interp = ((1 - fx) * (1 - fy) * nb[(iy, ix)]
                  + fx * (1 - fy) * nb[(iy, ix + 1)]
                  + (1 - fx) * fy * nb[(iy + 1, ix)]
                  + fx * fy * nb[(iy + 1, ix + 1)])
        fields_all.append(_moment_fields(cur_s, interp, ones))
    fs = jnp.stack(fields_all, axis=1).reshape(n_pix, n_sub * 7)
    sums = _contiguous_range_sums(fs, bounds)
    sums = jnp.transpose(sums.reshape(n_regions, n_sub, 7), (1, 0, 2))
    mad, zncc, _ = _cost_from_sums(sums, dt)
    sub_costs = coeff_mad * mad - coeff_zncc * zncc
    sbest = jnp.argmin(sub_costs, axis=0)
    best_cost = jnp.take_along_axis(sub_costs, sbest[None, :], axis=0)[0]
    best_d = best_d + jnp.asarray(sub_np, dt)[sbest]
    return best_d, best_cost


@functools.partial(
    jax.jit,
    static_argnames=("n_regions", "search_range", "subpixel_scale",
                     "coeff_mad", "coeff_zncc", "chunk", "method"))
def _match_one_direction(cur_lab, ref_lab, labels, perm, bounds,
                         n_regions: int,
                         search_range: int, subpixel_scale: int,
                         coeff_mad: float, coeff_zncc: float,
                         chunk: int = 16, method: str = "matmul"):
    """Best (dx, dy, cost) per region matching cur against ref.

    ``method`` selects the integer-search evaluator: ``"matmul"`` is the
    strip-one-hot matrix-product reduction (:func:`_integer_costs_matmul`);
    ``"matmul_bf16"`` the same reduction with bf16 matmul inputs + f32
    accumulation (winners match f32 except at near-ties — see
    :func:`_integer_costs_matmul`); ``"gather"`` is the
    permuted-gather + range-sum pass
    (:func:`_integer_costs`). ``chunk`` = candidates evaluated per pass
    (wider amortizes the gather / widens the matmul RHS)."""
    if method.startswith("matmul"):
        chunk = max(chunk, 64)
    if method.startswith("matmul_half"):
        # Half-resolution coarse sweep: the stride-2 full-res candidate
        # grid IS the all-integer half-res grid (d_full = 2 * d_half),
        # so the same candidate set — in the same canonical order —
        # evaluates on the stride-2-subsampled frames/labels at ~1/4 the
        # field-build + one-hot-matmul FLOPs. Frames are
        # anti-alias low-passed before the subsample (_half_res — the
        # strict subsample cost ranked coarse cells measurably worse).
        # The scoring tail is the shared stride-2 coarse tail at FULL
        # resolution: the inclusive sorted-tap refinement recovers the
        # odd cells and re-scores the winner's neighborhood on the true
        # frames (radius 2 for "matmul_half2" — hedges quarter-res
        # argmin errors by also re-scoring the even-cell neighbors).
        cand, _ = _coarse_padded_candidates(search_range, chunk, 2)
        costs = _integer_costs_matmul(
            _half_res(cur_lab), _half_res(ref_lab), labels[::2, ::2],
            n_regions, cand // 2, coeff_mad, coeff_zncc, chunk,
            -(-(search_range // 2) // 2), None)
        return _coarse_argmin_and_refine(
            costs, cur_lab, ref_lab, labels, perm, bounds, n_regions,
            search_range, subpixel_scale, coeff_mad, coeff_zncc, 2,
            refine_radius=2 if method.endswith("2") else 1)
    if method.startswith("matmul_coarse"):
        stride = 3 if method.endswith("3") else 2
        cand, _ = _coarse_padded_candidates(search_range, chunk, stride)
        costs = _integer_costs_matmul(cur_lab, ref_lab, labels, n_regions,
                                      cand, coeff_mad, coeff_zncc, chunk,
                                      search_range // 2, None)
        return _coarse_argmin_and_refine(
            costs, cur_lab, ref_lab, labels, perm, bounds, n_regions,
            search_range, subpixel_scale, coeff_mad, coeff_zncc, stride)
    cand = _padded_candidates(search_range, chunk)
    if method.startswith("matmul"):
        dot_dtype = jnp.bfloat16 if method == "matmul_bf16" else None
        costs = _integer_costs_matmul(cur_lab, ref_lab, labels, n_regions,
                                      cand, coeff_mad, coeff_zncc, chunk,
                                      search_range // 2, dot_dtype)
    else:
        costs = _integer_costs(cur_lab, ref_lab, perm, bounds, n_regions,
                               cand, coeff_mad, coeff_zncc, chunk)
    return _argmin_and_refine(costs, cur_lab, ref_lab, labels, perm,
                              bounds, n_regions, search_range,
                              subpixel_scale, coeff_mad, coeff_zncc)


@functools.partial(
    jax.jit,
    static_argnames=("n_regions", "search_range", "subpixel_scale",
                     "coeff_mad", "coeff_zncc", "chunk", "method"))
def _match_two_directions(cur_lab, refp_lab, refn_lab, labels, perm,
                          bounds, n_regions: int, search_range: int,
                          subpixel_scale: int, coeff_mad: float,
                          coeff_zncc: float, chunk: int = 64,
                          method: str = "matmul"):
    """Fused bidirectional :func:`_match_one_direction` (matmul methods
    only): one program evaluates both reference frames through
    :func:`_integer_costs_matmul_bidi`, then runs each direction's
    argmin + subpixel refinement. Each direction's output is
    bitwise-equal to its single-direction program."""
    chunk = max(chunk, 64)
    if method.startswith("matmul_half"):
        # Fused-bidirectional half-res sweep — see _match_one_direction.
        cand, _ = _coarse_padded_candidates(search_range, chunk, 2)
        costs_pair = _integer_costs_matmul_bidi(
            _half_res(cur_lab), _half_res(refp_lab),
            _half_res(refn_lab), labels[::2, ::2], n_regions,
            cand // 2, coeff_mad, coeff_zncc, chunk,
            -(-(search_range // 2) // 2), None)
        return tuple(
            _coarse_argmin_and_refine(
                costs, cur_lab, ref_lab, labels, perm, bounds, n_regions,
                search_range, subpixel_scale, coeff_mad, coeff_zncc, 2,
                refine_radius=2 if method.endswith("2") else 1)
            for costs, ref_lab in zip(costs_pair, (refp_lab, refn_lab)))
    if method.startswith("matmul_coarse"):
        stride = 3 if method.endswith("3") else 2
        cand, _ = _coarse_padded_candidates(search_range, chunk, stride)
        costs_pair = _integer_costs_matmul_bidi(
            cur_lab, refp_lab, refn_lab, labels, n_regions, cand,
            coeff_mad, coeff_zncc, chunk, search_range // 2, None)
        return tuple(
            _coarse_argmin_and_refine(
                costs, cur_lab, ref_lab, labels, perm, bounds, n_regions,
                search_range, subpixel_scale, coeff_mad, coeff_zncc,
                stride)
            for costs, ref_lab in zip(costs_pair, (refp_lab, refn_lab)))
    cand = _padded_candidates(search_range, chunk)
    dot_dtype = jnp.bfloat16 if method == "matmul_bf16" else None
    costs_pair = _integer_costs_matmul_bidi(
        cur_lab, refp_lab, refn_lab, labels, n_regions, cand, coeff_mad,
        coeff_zncc, chunk, search_range // 2, dot_dtype)
    return tuple(
        _argmin_and_refine(costs, cur_lab, ref_lab, labels, perm, bounds,
                           n_regions, search_range, subpixel_scale,
                           coeff_mad, coeff_zncc)
        for costs, ref_lab in zip(costs_pair, (refp_lab, refn_lab)))


def _match_device_bidirectional(cur_lab, refp_lab, refn_lab, labels,
                                n_regions: int, search_range, coeff_mad,
                                coeff_zncc, subpixel_scale, chunk,
                                method: str = "matmul"):
    """Dispatch BOTH directions' searches as one device program
    (matmul methods; the gather evaluator falls back to two
    :func:`_match_device` programs). Returns ((uv_p, cost_p),
    (uv_n, cost_n)) padded to the bucketed region count — no host
    sync."""
    validate_method(method)
    if not method.startswith("matmul"):
        return (_match_device(cur_lab, refp_lab, labels, n_regions,
                              search_range, coeff_mad, coeff_zncc,
                              subpixel_scale, chunk, method),
                _match_device(cur_lab, refn_lab, labels, n_regions,
                              search_range, coeff_mad, coeff_zncc,
                              subpixel_scale, chunk, method))
    perm, bounds = region_reduction_plan(np.asarray(labels),
                                         int(n_regions))
    n_pad = region_bucket(int(n_regions))
    bounds = pad_region_bounds(bounds, n_pad)
    return _match_two_directions(
        jnp.asarray(cur_lab), jnp.asarray(refp_lab), jnp.asarray(refn_lab),
        jnp.asarray(labels), jnp.asarray(perm), jnp.asarray(bounds),
        n_pad, int(search_range), int(subpixel_scale), float(coeff_mad),
        float(coeff_zncc), int(chunk), method)


def _match_device(cur_lab, ref_lab, labels, n_regions: int, search_range,
                  coeff_mad, coeff_zncc, subpixel_scale, chunk,
                  method: str = "matmul"):
    """Dispatch one direction's search; returns device arrays (uv, cost)
    padded to the bucketed region count — no host sync."""
    validate_method(method)
    perm, bounds = region_reduction_plan(np.asarray(labels),
                                         int(n_regions))
    # Bucket the static region count so frame-to-frame drift in the
    # mean-shift segmentation reuses the compiled search (a fresh count
    # would recompile the whole search).
    n_pad = region_bucket(int(n_regions))
    bounds = pad_region_bounds(bounds, n_pad)
    return _match_one_direction(
        jnp.asarray(cur_lab), jnp.asarray(ref_lab), jnp.asarray(labels),
        jnp.asarray(perm), jnp.asarray(bounds), n_pad, int(search_range),
        int(subpixel_scale), float(coeff_mad), float(coeff_zncc),
        int(chunk), method)


def _result_from_host(uv, cost, lab_np, n_regions: int) -> BlockMatchResult:
    uv = np.asarray(uv)[:n_regions]
    cost = np.asarray(cost)[:n_regions]
    return BlockMatchResult(
        u=uv[lab_np][..., 0], v=uv[lab_np][..., 1], cost=cost[lab_np],
        region_uv=uv, region_cost=cost)


def block_matching_labels(
    cur_lab,
    ref_lab,
    labels,
    n_regions: int,
    search_range: int = 61,
    coeff_mad: float = 1.0,
    coeff_zncc: float = 0.5,
    subpixel_scale: int = 2,
    chunk: int = 16,
    method: str = "matmul",
) -> BlockMatchResult:
    """Match every region of ``cur`` against ``ref``; vectors point from
    cur pixels toward their reference-frame position (inverse flow, like
    the reference's get_prev)."""
    uv, cost = _match_device(cur_lab, ref_lab, labels, n_regions,
                             search_range, coeff_mad, coeff_zncc,
                             subpixel_scale, chunk, method)
    uv, cost = jax.device_get((uv, cost))
    return _result_from_host(uv, cost, np.asarray(labels), int(n_regions))


def block_matching_bidirectional(
    cur_lab,
    prev_lab,
    next_lab,
    labels,
    n_regions: int,
    search_range: int = 61,
    coeff_mad: float = 1.0,
    coeff_zncc: float = 0.5,
    subpixel_scale: int = 2,
    chunk: int = 16,
    method: str = "matmul",
):
    """Bidirectional matching: returns (prev_result, next_result,
    t (H, W) in {-1, +1}) with t = -1 where the prev match wins
    (BlockMatching::get's Vector_ST time direction).

    Both directions run as ONE device program for the matmul methods
    (:func:`_match_device_bidirectional` shares the cur-side moment
    fields and validity masks between the directions) and the host fetch
    waits once."""
    d_prev, d_next = _match_device_bidirectional(
        cur_lab, prev_lab, next_lab, labels, n_regions, search_range,
        coeff_mad, coeff_zncc, subpixel_scale, chunk, method)
    (uv_p, c_p), (uv_n, c_n) = jax.device_get((d_prev, d_next))
    lab_np = np.asarray(labels)
    r_prev = _result_from_host(uv_p, c_p, lab_np, int(n_regions))
    r_next = _result_from_host(uv_n, c_n, lab_np, int(n_regions))
    t = np.where(r_prev.cost <= r_next.cost, -1, 1).astype(np.int8)
    return r_prev, r_next, t
