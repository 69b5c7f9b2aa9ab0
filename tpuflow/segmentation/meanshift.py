"""Mean-shift segmentation over CIE-Lab (the missing ``Segmentation<Lab>``).

The reference's flagship path constructs ``Segmentation<Lab>(img, 20,
16/255)`` (OpticalFlow_BlockMatching.cpp:122-135) from the absent ImgClass
submodule; its required surface (SURVEY.md §2.4) is

- ``ref_segmentation_map()`` — per-pixel region label,
- ``ref_regions()``         — per-region pixel lists,
- ``ref_shift_vector_spatial()`` — per-pixel converged spatial position
  (written as ``shift - (x, y)`` side output, lines 183-196).

Reconstruction (Comaniciu-Meer mean-shift segmentation): every pixel is a
point in joint (x, y, L, a, b) space; each query point iteratively moves
to the mean of the *original* data points within a flat kernel (spatial
radius ``kernel_spatial``, Lab-space radius ``kernel_intensity``); pixels
whose modes coincide (within half a kernel) and touch form a region.

Design: the filtering iterations are the hot part and run fully on
device — a fixed number of mean-shift steps, each a dense sweep over a
window of *static shifts* of the original frame (contiguous
dynamic_slices of a sentinel-padded copy instead of random gathers at
the moving query centers, and the sentinel border replaces
the per-offset validity mask entirely). The shift window spans
kernel_spatial + margin, which makes the step EXACT for every query
whose mode has drifted at most ``margin`` pixels from its origin
(margin defaults to kernel_spatial; iteration 0's window shrinks to R —
its queries have drift exactly 0; measured on
the bundled KITTI frame a small tail of pixels drifts past ANY
practical margin — their truncated-window modes stay in the right basin
and the near-mode label merge absorbs the error). Labeling is irregular
graph work on tiny data and runs host-side (native C++ union-find, the
NumPy/SciPy path as oracle), per SURVEY.md §7.3.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

def _color_sentinel(lab: jnp.ndarray, kernel_intensity: float):
    """Pad value for the frame borders: farther than ``kernel_intensity``
    from EVERY real color, so a data point read outside the image fails
    the color-radius test by construction — which replaces the
    per-offset validity mask (the mask was ~25% of the sweep's VPU
    ops)."""
    return (jnp.max(jnp.abs(lab)) + jnp.asarray(
        float(kernel_intensity) + 1.0, lab.dtype)).astype(lab.dtype)


def _ms_bands(E_k: int, quant: int = 4) -> tuple[tuple[int, int, int], ...]:
    """Banded-disc offset window: contiguous dy runs with constant
    quantized x-half-width.

    The spatial kernel test is Euclidean: within the drift contract
    (|drift| <= margin) a data point at static offset (dx, dy) can only
    pass ``d_sp <= R^2`` when |(dx, dy)| <= R + drift <= E — so the DISC
    of radius E around the origin is the exact sound superset of the
    square sweep (the square's corner offsets contribute exact +0.0 for
    every in-contract query; they only ever fired for out-of-contract
    drift>margin outliers, where the window is truncated/approximate
    either way). Restricting the sweep to the disc cuts ~21.5% of the
    offsets (pi/4). Bands quantize the per-row half-width UP to a
    multiple of ``quant`` so XLA sees ~21 loop nests instead of 648
    unrolled bodies; outputs are bitwise-equal to the square window on
    frames whose modes drift less than the margin.

    Returns (dy_lo, dy_hi, half_width) runs in ascending dy order, so
    the row-major accumulation order of the kept offsets is preserved
    and the sums are bitwise the square sweep's wherever the dropped
    offsets weigh zero.
    """
    import math

    bands: list[list[int]] = []
    for dy in range(-E_k, E_k + 1):
        wdx = math.isqrt(E_k * E_k - dy * dy)
        wg = min(E_k, ((wdx + quant - 1) // quant) * quant)
        if bands and bands[-1][2] == wg:
            bands[-1][1] = dy
        else:
            bands.append([dy, dy, wg])
    return tuple(tuple(b) for b in bands)


def _ms_window(it: int, R: int, E: int) -> int:
    """Offset-window half-width for mean-shift iteration ``it``.

    Iteration 0's queries ARE their origins (drift exactly 0), so a
    radius-R window provably covers every nonzero weight — the skipped
    offsets add exact 0.0s and the shrunk window is bitwise the full
    one. Later iterations use the full R + margin window: the general
    'drift after k steps <= k*R' bound is UNSOUND under the legacy
    empty-window reset (a query whose window empties jumps to (0, 0),
    i.e. drift up to |origin|), so no further shrink is taken."""
    return R if it == 0 else E


def _ms_step(labh, state, xs, ys, E: int, E_k: int,
             hs2: float, hr2: float):
    """One mean-shift step over sentinel-padded channel planes.

    The ONE copy of the accumulation algebra shared by the
    single-device filter and the sharded tile body — the bitwise
    single-vs-distributed contract rides on it. ``labh``: three
    (h + 2E, w + 2E) planes; ``state`` = (ex, ey, c0, c1, c2) per-pixel
    drift + query colors at (h, w); ``xs``/``ys``: GLOBAL pixel
    coordinates of this (h, w) block (the legacy empty-window reset
    jumps to global (0, 0), i.e. drift -xs/-ys).

    Nested row/column loops: the y-part of the spatial test and the
    row-band slices hoist to the dy loop (the row-major offset order is
    preserved, so the sums are bitwise the flat loop's — measured
    0.63 -> 0.48 s at KITTI res R=20). The sweep covers the banded DISC
    of radius E_k (:func:`_ms_bands`) rather than the full square —
    the square's corner offsets are exact +0.0 for every in-contract
    query (measured 0.406 -> 0.352 s)."""
    ex, ey, c0, c1, c2 = state
    h, w = ex.shape
    dt = ex.dtype

    acc = tuple(jnp.zeros((h, w), dt) for _ in range(6))
    for dy_lo, dy_hi, wg in _ms_bands(E_k):

        def outer(i, acc, dy_lo=dy_lo, wg=wg):
            dy = i + dy_lo
            dyf = dy.astype(dt)
            ty2 = (dyf - ey) ** 2
            # Full-width row band: one slice per band row, columns
            # sliced per offset below.
            b0 = jax.lax.dynamic_slice(labh[0], (E + dy, 0), (h, w + 2 * E))
            b1 = jax.lax.dynamic_slice(labh[1], (E + dy, 0), (h, w + 2 * E))
            b2 = jax.lax.dynamic_slice(labh[2], (E + dy, 0), (h, w + 2 * E))

            def inner(j, acc):
                s_dx, s_dy, s0, s1, s2, s_n = acc
                dx = j - wg
                dxf = dx.astype(dt)
                # Data point at the static offset from the ORIGIN pixel:
                q0 = jax.lax.dynamic_slice(b0, (0, E + dx), (h, w))
                q1 = jax.lax.dynamic_slice(b1, (0, E + dx), (h, w))
                q2 = jax.lax.dynamic_slice(b2, (0, E + dx), (h, w))
                d_sp = (dxf - ex) ** 2 + ty2
                d_cl = (q0 - c0) ** 2 + (q1 - c1) ** 2 + (q2 - c2) ** 2
                wgt = jnp.where((d_sp <= hs2) & (d_cl <= hr2), 1.0, 0.0
                                ).astype(dt)
                # dx/dy are scalars: accumulating wgt*d instead of
                # wgt*(origin+d) drops the per-offset coordinate builds.
                return (s_dx + wgt * dxf, s_dy + wgt * dyf,
                        s0 + wgt * q0, s1 + wgt * q1, s2 + wgt * q2,
                        s_n + wgt)

            # unroll: XLA fuses 8 offsets' slices + tests into one kernel
            # per carry round-trip — fusing 8 offsets cuts the carry's HBM
            # traffic ~5x; beyond that the sweep is VPU-compute-bound
            # (unroll 16/32 measured 0.67/0.75 s vs 0.64 — register
            # pressure).
            return jax.lax.fori_loop(0, 2 * wg + 1, inner, acc, unroll=8)

        acc = jax.lax.fori_loop(0, dy_hi - dy_lo + 1, outer, acc)
    s_dx, s_dy, s0, s1, s2, s_n = acc
    n = jnp.maximum(s_n, 1.0)
    # Mean position = origin + mean offset: the drift carries the small
    # quantity directly (no large-coordinate cancellation). The
    # all-points-excluded edge case keeps the legacy semantics
    # (position resets to global (0, 0), i.e. drift -xs).
    got = s_n > 0
    return (jnp.where(got, s_dx / n, -xs),
            jnp.where(got, s_dy / n, -ys),
            s0 / n, s1 / n, s2 / n)


@dataclass
class SegmentationResult:
    """The ``Segmentation<Lab>`` surface."""

    labels: np.ndarray          # (H, W) int32 region ids, 0..n_regions-1
    n_regions: int
    shift_spatial: np.ndarray   # (H, W, 2) converged (x, y) positions
    shift_color: np.ndarray     # (H, W, 3) converged Lab
    regions: list[np.ndarray] | None = None  # lazily built (N_i, 2) (x, y)

    def build_regions(self) -> list[np.ndarray]:
        """ref_regions(): per-region (x, y) pixel lists."""
        if self.regions is None:
            h, w = self.labels.shape
            ys, xs = np.mgrid[0:h, 0:w]
            flat = self.labels.reshape(-1)
            order = np.argsort(flat, kind="stable")
            pts = np.stack([xs.reshape(-1)[order], ys.reshape(-1)[order]], -1)
            counts = np.bincount(flat, minlength=self.n_regions)
            self.regions = list(np.split(pts, np.cumsum(counts)[:-1]))
        return self.regions


@functools.partial(jax.jit, static_argnames=("kernel_spatial",
                                             "kernel_intensity", "iters",
                                             "margin", "with_drift",
                                             "return_trajectory"))
def mean_shift_filter(
    lab: jnp.ndarray,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    iters: int = 8,
    margin: int | None = None,
    with_drift: bool = False,
    return_trajectory: bool = False,
):
    """Run ``iters`` mean-shift steps; returns (pos (H,W,2) xy, color (H,W,3)).

    ``lab`` is (H, W, 3) normalized Lab. Flat kernels: spatial radius
    ``kernel_spatial`` (pixels), color radius ``kernel_intensity``
    (Euclidean in Lab). ``margin`` bounds the tracked mode drift (exact
    for drift <= margin; defaults to kernel_spatial).

    ``with_drift=True`` additionally returns the max |pos - origin| seen
    at any GATHER (i.e. over every intermediate query position). This
    certifies a reduced margin after the fact: positions stay exact up
    to the first drift > margin, so a reported max drift <= margin
    proves every gather saw its full kernel window
    (:func:`segment_meanshift`'s adaptive-margin fast path).
    """
    h, w = lab.shape[:2]
    dt = lab.dtype
    R = int(kernel_spatial)
    M = R if margin is None else int(margin)
    hs2 = float(kernel_spatial) ** 2
    hr2 = float(kernel_intensity) ** 2

    xs = jnp.arange(w, dtype=dt)[None, :] * jnp.ones((h, 1), dt)
    ys = jnp.arange(h, dtype=dt)[:, None] * jnp.ones((1, w), dt)

    # Shift window: every data point within R of a query that drifted <= M
    # from its origin lies within R + M of the origin.
    E = R + M
    # E-padded per-channel copies: the per-offset read becomes a
    # contiguous dynamic_slice (cheaper than a wrap-around roll). The pad
    # value is a color SENTINEL farther than the color radius from every
    # real value (so out-of-image data points weigh 0 with no explicit
    # validity mask). Per-channel (H, W) planes keep each slice a dense
    # 2-D copy.
    sentinel = _color_sentinel(lab, kernel_intensity)
    labh = [jnp.pad(lab[..., c], E, constant_values=sentinel)
            for c in range(3)]
    c_orig = [lab[..., c] for c in range(3)]

    state = (jnp.zeros((h, w), dt), jnp.zeros((h, w), dt), *c_orig)
    max_drift = jnp.asarray(0.0, dt)
    traj = []
    for it in range(iters):
        if with_drift:
            ex, ey = state[0], state[1]
            max_drift = jnp.maximum(max_drift,
                                    jnp.sqrt(jnp.max(ex * ex + ey * ey)))
        state = _ms_step(labh, state, xs, ys, E, _ms_window(it, R, E),
                         hs2, hr2)
        if return_trajectory:
            traj.append(jnp.stack([state[0], state[1]], axis=-1))
    ex, ey, c0, c1, c2 = state
    pos = jnp.stack([xs + ex, ys + ey], axis=-1)
    cl = jnp.stack([c0, c1, c2], axis=-1)
    out = (pos, cl)
    if with_drift:
        out = out + (max_drift,)
    if return_trajectory:
        # (iters, H, W, 2) per-iteration DRIFT (position - origin) after
        # each step — the per-iteration window-schedule evidence.
        out = out + (jnp.stack(traj),)
    return out


def _merge_labels(pos: np.ndarray, col: np.ndarray,
                  kernel_spatial: float, kernel_intensity: float,
                  min_size: int) -> tuple[np.ndarray, int]:
    """Host-side region formation: join 4-adjacent pixels whose modes are
    within half a kernel, then absorb regions smaller than min_size into
    their most-similar touching neighbor.

    Dispatches to the native C++ union-find labeler (tf_label_regions,
    tpuflow/native/io_native.cpp — the host half of the reference's C++
    Segmentation<Lab>, bit-identical and ~10x the numpy/scipy path);
    falls back to the Python implementation when the native library is
    unavailable."""
    try:
        from tpuflow.native import label_regions

        return label_regions(pos, col, kernel_spatial, kernel_intensity,
                             min_size)
    except Exception:
        return _merge_labels_py(pos, col, kernel_spatial,
                                kernel_intensity, min_size)


def _merge_labels_py(pos: np.ndarray, col: np.ndarray,
                     kernel_spatial: float, kernel_intensity: float,
                     min_size: int) -> tuple[np.ndarray, int]:
    """Pure-Python :func:`_merge_labels` (the native labeler's oracle)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = pos.shape[:2]
    idx = np.arange(h * w).reshape(h, w)
    feats = np.concatenate([pos, col], axis=-1)  # (H, W, 5)

    rows, cols = [], []
    sp_th = (0.5 * kernel_spatial) ** 2
    cl_th = kernel_intensity**2
    for axis, sl_a, sl_b in (
            (0, (slice(0, h - 1), slice(None)), (slice(1, h), slice(None))),
            (1, (slice(None), slice(0, w - 1)), (slice(None), slice(1, w)))):
        fa = feats[sl_a].reshape(-1, 5)
        fb = feats[sl_b].reshape(-1, 5)
        d_sp = ((fa[:, :2] - fb[:, :2]) ** 2).sum(-1)
        d_cl = ((fa[:, 2:] - fb[:, 2:]) ** 2).sum(-1)
        ok = (d_sp <= sp_th) & (d_cl <= cl_th)
        rows.append(idx[sl_a].reshape(-1)[ok])
        cols.append(idx[sl_b].reshape(-1)[ok])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    g = coo_matrix((np.ones(len(r)), (r, c)), shape=(h * w, h * w))
    n, lab = connected_components(g, directed=False)
    lab = lab.reshape(h, w)

    if min_size > 1:
        # Tiny-region absorption at REGION level: pixel-level sums,
        # counts and the region adjacency are computed ONCE; the merge
        # loop then runs on arrays of size n (thousands) instead of
        # re-scanning the 466k-pixel frame per iteration (the pixel-level
        # loop measured ~0.6 s/frame at KITTI res on the flagship path).
        flat_lab0 = lab.reshape(-1)
        flat_col = col.reshape(-1, 3)
        counts = np.bincount(flat_lab0, minlength=n).astype(np.int64)
        col_sums = np.stack(
            [np.bincount(flat_lab0, weights=flat_col[:, c], minlength=n)
             for c in range(3)], axis=-1)
        # Region adjacency from the pixel boundary pairs (both
        # directions), deduplicated.
        eas, ebs = [], []
        for sl_a, sl_b in (
                ((slice(0, h - 1), slice(None)), (slice(1, h), slice(None))),
                ((slice(None), slice(0, w - 1)), (slice(None), slice(1, w)))):
            la = lab[sl_a].reshape(-1)
            lb = lab[sl_b].reshape(-1)
            m = la != lb
            eas.append(la[m])
            ebs.append(lb[m])
        ea = np.concatenate(eas + ebs)
        eb = np.concatenate(ebs + eas)
        edges = np.unique(ea.astype(np.int64) * n + eb)
        ea = (edges // n).astype(np.int64)
        eb = (edges % n).astype(np.int64)

        remap_total = np.arange(n)
        for _ in range(64):  # until no tiny region remains (or give up)
            is_tiny = (counts > 0) & (counts < min_size)
            if not is_tiny.any():
                break
            mean_col = col_sums / np.maximum(counts, 1)[:, None]
            sel = is_tiny[ea]
            pa, pb = ea[sel], eb[sel]
            if len(pa) == 0:
                break
            d = ((mean_col[pa] - mean_col[pb]) ** 2).sum(-1)
            order = np.lexsort((d, pa))      # grouped by tiny id, best first
            pa_s, pb_s = pa[order], pb[order]
            first = np.ones(len(pa_s), bool)
            first[1:] = pa_s[1:] != pa_s[:-1]
            src = pa_s[first]
            dst = pb_s[first]
            # Tiny-into-tiny merges only toward smaller ids — breaks the
            # a<->b swap cycles that would otherwise never terminate.
            keep = (~is_tiny[dst]) | (dst < src)
            src, dst = src[keep], dst[keep]
            if len(src) == 0:
                break
            remap = np.arange(n)
            remap[src] = dst
            # Resolve chains.
            for _ in range(8):
                remap = remap[remap]
            # Fold the merged regions' mass into their destinations and
            # contract the adjacency.
            counts_new = np.bincount(remap, weights=counts,
                                     minlength=n).astype(np.int64)
            col_sums = np.stack(
                [np.bincount(remap, weights=col_sums[:, c], minlength=n)
                 for c in range(3)], axis=-1)
            counts = counts_new
            remap_total = remap[remap_total]
            ea = remap[ea]
            eb = remap[eb]
            inner = ea != eb
            ea, eb = ea[inner], eb[inner]
            edges = np.unique(ea * n + eb)
            ea = edges // n
            eb = edges % n
        lab = remap_total[lab]
        # Compact labels.
        uniq, lab = np.unique(lab, return_inverse=True)
        lab = lab.reshape(h, w)
        n = len(uniq)
    return lab.astype(np.int32), n


def _upsample_segmentation(labels, n, pos, col, s: int, h: int,
                           w: int) -> SegmentationResult:
    """Expand a 1/s-resolution segmentation to full resolution: labels
    nearest-replicated (each sample pixel stands for its s x s block),
    converged positions mapped back to full-res coordinates (x s)."""
    rep = lambda a: np.repeat(np.repeat(a, s, 0), s, 1)[:h, :w]  # noqa
    return SegmentationResult(
        labels=np.ascontiguousarray(rep(labels)), n_regions=n,
        shift_spatial=rep(pos) * s, shift_color=rep(col))


def segment_meanshift(
    lab: np.ndarray,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    iters: int = 8,
    min_size: int = 16,
    margin: int | str | None = None,
    scale: int = 1,
) -> SegmentationResult:
    """Full segmentation: device mean-shift filtering + host labeling.

    ``margin=None`` (default) uses the window-tracking margin R. Measured
    caveat: a few pixels' modes drift FARTHER than R on real imagery
    (max drift 42 px at R=20 on the bundled KITTI frame), so the filter
    is approximate for those outliers under any practical margin — their
    truncated-window modes still land in the right basin and the
    labeling's near-mode merge absorbs the error (the brute-force oracle
    test bounds the small-drift regime exactly).

    ``margin="auto"`` runs a reduced margin (R/2) first and retries at
    full margin unless the max-drift certificate
    (:func:`mean_shift_filter` ``with_drift``) proves the fast pass saw
    full windows. On the bundled imagery the certificate essentially
    never holds (drift > R/2 within 8 iterations), so this is NOT the
    default — it exists for smooth/low-drift inputs.

    ``scale > 1`` (the fast profile's segmentation lever) runs the
    whole segmentation on the stride-``scale`` subsampled frame with
    the spatial kernel and min_size scaled to match (same physical
    extents), then nearest-replicates the labels back to full
    resolution — ~scale^4 less filter work (pixels x window offsets).
    NOT faithful to the reference's full-res segmentation;
    quality-guarded at corpus level."""
    lab_j = jnp.asarray(lab)
    h0, w0 = lab_j.shape[:2]
    if scale > 1:
        lab_j = lab_j[::scale, ::scale]
        kernel_spatial = max(int(kernel_spatial) // scale, 1)
        min_size = max(int(min_size) // (scale * scale), 1)
    R = int(kernel_spatial)
    if margin == "auto" and R > 2:
        m0 = max(R // 2, 1)
        pos, col, drift = mean_shift_filter(
            lab_j, kernel_spatial, float(kernel_intensity), iters,
            margin=m0, with_drift=True)
        if float(drift) > m0:
            pos, col = mean_shift_filter(lab_j, kernel_spatial,
                                         float(kernel_intensity), iters)
    else:
        pos, col = mean_shift_filter(
            lab_j, kernel_spatial, float(kernel_intensity), iters,
            margin=None if margin in (None, "auto") else int(margin))
    pos = np.asarray(pos)
    col = np.asarray(col)
    labels, n = _merge_labels(pos, col, float(kernel_spatial),
                              float(kernel_intensity), min_size)
    if scale > 1:
        return _upsample_segmentation(labels, n, pos, col, scale, h0, w0)
    return SegmentationResult(labels=labels, n_regions=n,
                              shift_spatial=pos, shift_color=col)


def segment_meanshift_async(
    lab,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    iters: int = 8,
    min_size: int = 16,
    margin: int | None = None,
    mesh=None,
    scale: int = 1,
):
    """:func:`segment_meanshift` split into device dispatch + deferred
    host finalize.

    Dispatches the mean-shift filter on device and returns a zero-arg
    ``finalize`` callable that fetches the filter output and runs the
    host labeling. Callers queue *other* device work between dispatch
    and finalize so the host labeling (~0.15-1 s at KITTI res) overlaps
    with it — the flagship driver overlaps the new frame's labeling with
    the middle frame's block matching + refinement
    (device order: filter first, so the fetch inside ``finalize`` only
    waits for the filter, not the queued matching work).

    ``mesh`` routes the filter through
    :func:`mean_shift_filter_sharded` (image tiled over the device
    mesh); the labeling is global and stays on the host. ``scale``:
    see :func:`segment_meanshift` (single-device only).
    """
    lab_j = jnp.asarray(lab)
    h0, w0 = lab_j.shape[:2]
    if scale > 1:
        if mesh is not None:
            raise ValueError("scale > 1 is single-device only")
        lab_j = lab_j[::scale, ::scale]
        kernel_spatial = max(int(kernel_spatial) // scale, 1)
        min_size = max(int(min_size) // (scale * scale), 1)
    if mesh is not None:
        pos, col = mean_shift_filter_sharded(
            lab_j, mesh, kernel_spatial, float(kernel_intensity), iters,
            margin=margin)
    else:
        pos, col = mean_shift_filter(
            lab_j, kernel_spatial, float(kernel_intensity), iters,
            margin=None if margin is None else int(margin))

    def finalize() -> SegmentationResult:
        pos_np = np.asarray(pos)
        col_np = np.asarray(col)
        labels, n = _merge_labels(pos_np, col_np, float(kernel_spatial),
                                  float(kernel_intensity), min_size)
        if scale > 1:
            return _upsample_segmentation(labels, n, pos_np, col_np,
                                          scale, h0, w0)
        return SegmentationResult(labels=labels, n_regions=n,
                                  shift_spatial=pos_np, shift_color=col_np)

    return finalize


@functools.lru_cache(maxsize=32)
def _ms_sharded_fn(mesh, h: int, w: int, kernel_spatial: int,
                   kernel_intensity: float, iters: int, E: int):
    import jax as _jax
    from jax import lax as _lax
    from jax.sharding import PartitionSpec as P

    from tpuflow.dist.halo import halo_pad_2d
    from tpuflow.dist.solvers import shard_map

    ty, tx = mesh.devices.shape
    th, tw = h // ty, w // tx
    hs2 = float(kernel_spatial) ** 2
    hr2 = float(kernel_intensity) ** 2
    spec = P("ty", "tx", None)

    R = int(kernel_spatial)

    def tile_body(lab_t):
        dt = lab_t.dtype
        row0 = (_lax.axis_index("ty") * th).astype(dt)
        col0 = (_lax.axis_index("tx") * tw).astype(dt)
        # Same sentinel as the single-device filter: a GLOBAL max over
        # the tiles (max is exactly order-insensitive, so the psum-free
        # pmax matches jnp.max bitwise).
        sentinel = _lax.pmax(
            _lax.pmax(jnp.max(jnp.abs(lab_t)), "ty"), "tx") + jnp.asarray(
                float(kernel_intensity) + 1.0, dt)
        # Halo-exchanged per-channel planes; ppermute fills non-existent
        # neighbors with zeros, so overwrite everything outside the
        # global frame with the sentinel.
        gys = (row0 - E) + jnp.arange(th + 2 * E, dtype=dt)[:, None]
        gxs = (col0 - E) + jnp.arange(tw + 2 * E, dtype=dt)[None, :]
        outside = (gys < 0) | (gys >= h) | (gxs < 0) | (gxs >= w)
        labh = [jnp.where(outside, sentinel, halo_pad_2d(lab_t[..., c], E))
                for c in range(3)]
        xs = col0 + jnp.arange(tw, dtype=dt)[None, :] * jnp.ones((th, 1), dt)
        ys = row0 + jnp.arange(th, dtype=dt)[:, None] * jnp.ones((1, tw), dt)

        # The iteration body is THE single-device step (_ms_step): a
        # dynamic window of the halo'd tile == the roll of the global
        # frame restricted to this tile, and the global xs/ys carry the
        # legacy empty-window reset — bitwise-equal sums by sharing the
        # one copy of the accumulation algebra.
        z = jnp.zeros((th, tw), dt)
        state = (z, z, lab_t[..., 0], lab_t[..., 1], lab_t[..., 2])
        for it in range(iters):
            state = _ms_step(labh, state, xs, ys, E, _ms_window(it, R, E),
                             hs2, hr2)
        ex, ey, c0, c1, c2 = state
        return (jnp.stack([xs + ex, ys + ey], axis=-1),
                jnp.stack([c0, c1, c2], axis=-1))

    return _jax.jit(shard_map(tile_body, mesh, in_specs=spec,
                              out_specs=(spec, spec)))


def mean_shift_filter_sharded(
    lab,
    mesh,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    iters: int = 8,
    margin: int | None = None,
):
    """Distributed :func:`mean_shift_filter` over a ("ty", "tx") mesh.

    The static-shift window reads data only within E = R + margin pixels
    of each query's ORIGIN pixel, so one halo exchange of the Lab frame
    (width E, sentinel-filled outside the global frame — out-of-image
    data points fail the color test exactly as in the single-device
    step) makes the entire iteration loop tile-local.
    Bitwise-identical accumulation order to the single-device filter
    (equivalence test on the virtual CPU mesh, tests/test_dist.py).
    Multi-chip analogue of the reference's OpenMP row loop inside
    Segmentation<Lab> (SURVEY.md §2.4, §2.6).
    """
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    lab = jnp.asarray(lab)
    h, w = lab.shape[:2]
    ty, tx = mesh.devices.shape
    if h % ty or w % tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh {ty}x{tx}")
    th, tw = h // ty, w // tx
    R = int(kernel_spatial)
    M = R if margin is None else int(margin)
    E = R + M
    if E > th or E > tw:
        raise ValueError("tile smaller than the shift window halo")

    lab_sh = _jax.device_put(lab, NamedSharding(mesh, P("ty", "tx", None)))
    f = _ms_sharded_fn(mesh, h, w, int(kernel_spatial),
                       float(kernel_intensity), int(iters), E)
    return f(lab_sh)
