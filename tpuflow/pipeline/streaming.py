"""Streaming drivers — the Video*OF demos re-designed as generators.

- :func:`dense_flow_stream` — VideoDenseOF (``DenseFlow.cpp:12-59``):
  per frame: resize to the working resolution (640x480 in the demo),
  grayscale, dense Farneback against the previous frame
  ((0.4, 1, 48, 2, 8, 1.2), line 37), quiver overlay. The previous gray
  frame is the carried warm state (line 51); optionally the previous
  *flow* seeds the next solve (OPTFLOW_USE_INITIAL_FLOW) — the explicit
  warm-start config.
- :func:`feature_tracking_stream` — VideoFeaturesOF
  (``FeaturesOpticalFlow.cpp:44-130``) and the LucasKanadeOF pair demo:
  goodFeaturesToTrack seeding (maxCount 500, quality 0.01, minDist 10),
  pyramidal LK tracking, accept rule ``status && |dx|+|dy| > 2``,
  re-seed when <= 10 tracks survive.

Frame sources: the reference consumes ``highway.mov`` which is absent
from its snapshot (SURVEY.md §0); :class:`ImageSequenceSource` (printf
patterns over the bundled KITTI pairs) and :class:`SyntheticSource`
(moving-texture generator) stand in, and any iterator of (H, W[,3])
arrays works. State objects are explicit and picklable (checkpoint /
resume, SURVEY.md §5.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

import jax.numpy as jnp
import numpy as np

from tpuflow.core import io as tio
from tpuflow.core.color import rgb_to_gray
from tpuflow.core.resample import resize_zero_order_hold
from tpuflow.utils.telemetry import get_telemetry


# ---------------------------------------------------------------------------
# Frame sources


class ImageSequenceSource:
    """Frames from a printf-style filename pattern (``%0Nd``).

    ``prefetch=True`` decodes ahead on native worker threads
    (:class:`tpuflow.native.FramePrefetcher`) for binary PNM sequences so
    the device never waits on disk; other formats stream synchronously.
    """

    def __init__(self, pattern: str, start: int, end: int,
                 prefetch: bool = False, threads: int = 2):
        self.pattern = pattern
        self.start = start
        self.end = end
        self.prefetch = prefetch
        self.threads = threads

    def _paths(self):
        return [tio.expand_frame_pattern(self.pattern, num)
                for num in range(self.start, self.end + 1)]

    def __iter__(self) -> Iterator[np.ndarray]:
        paths = self._paths()
        if self.prefetch and all(
                str(p).lower().endswith((".pgm", ".ppm")) for p in paths):
            try:
                from tpuflow.native import FramePrefetcher

                with FramePrefetcher(paths, threads=self.threads) as pf:
                    for frame, _ in pf:
                        yield frame
                return
            except Exception:
                pass  # fall back to synchronous reads
        for p in paths:
            frame, _ = tio.read_image(p)
            yield frame


class SyntheticSource:
    """Moving smoothed-noise texture with constant (dx, dy) per frame."""

    def __init__(self, n_frames: int = 10, h: int = 120, w: int = 160,
                 dx: float = 2.0, dy: float = 0.0, seed: int = 0):
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(seed)
        margin = int(abs(dx) * n_frames + abs(dy) * n_frames) + 4
        base = rng.uniform(0, 255, (h + 2 * margin, w + 2 * margin))
        self.base = gaussian_filter(base, 2.0)
        self.n_frames = n_frames
        self.h, self.w = h, w
        self.dx, self.dy = dx, dy
        self.margin = margin

    def __iter__(self) -> Iterator[np.ndarray]:
        from scipy.ndimage import shift as ndshift

        for i in range(self.n_frames):
            ox = self.margin + self.dx * i
            oy = self.margin + self.dy * i
            f = ndshift(self.base, (-oy, -ox), order=1)[: self.h, : self.w]
            yield f


def video_source(path: str | Path) -> Iterator[np.ndarray]:
    """Frames from a video file via OpenCV, if available."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame[..., ::-1]  # BGR -> RGB
    finally:
        cap.release()


# ---------------------------------------------------------------------------
# Dense streaming flow


@dataclass
class DenseStreamState:
    prev_gray: np.ndarray | None = None
    prev_flow: tuple | None = None


def dense_flow_stream(
    frames: Iterable[np.ndarray],
    working_size: tuple[int, int] | None = (640, 480),
    pyr_scale: float = 0.4,
    levels: int = 1,
    winsize: int = 48,
    iterations: int = 2,
    poly_n: int = 8,
    poly_sigma: float = 1.2,
    warm_start_flow: bool = False,
    state: DenseStreamState | None = None,
):
    """Yields (gray_frame, u, v) per frame after the first
    (DenseFlow.cpp's loop; parameters from line 37)."""
    from tpuflow.solvers import calc_optical_flow_farneback

    if state is None:
        state = DenseStreamState()
    tel = get_telemetry()
    for i, frame in enumerate(frames):
        if frame.ndim == 3:
            gray = np.asarray(rgb_to_gray(jnp.asarray(frame, jnp.float32)))
        else:
            gray = np.asarray(frame, np.float32)
        if working_size is not None:
            gray = np.asarray(resize_zero_order_hold(
                jnp.asarray(gray), working_size))
        if state.prev_gray is not None:
            flags = 0x100 if (warm_start_flow and state.prev_flow) else 0
            u, v = calc_optical_flow_farneback(
                jnp.asarray(state.prev_gray), jnp.asarray(gray),
                state.prev_flow if flags else None,
                pyr_scale, levels, winsize, iterations, poly_n, poly_sigma,
                flags)
            u = np.asarray(u)
            v = np.asarray(v)
            state.prev_flow = (u, v)
            tel.event("stream.dense", frame=i, mean_u=float(u.mean()),
                      mean_v=float(v.mean()))
            yield gray, u, v
        state.prev_gray = gray


def bm_flow_stream(
    frames: Iterable[np.ndarray],
    max_int: float = 255.0,
    prewarm: bool = True,
    **driver_kwargs,
):
    """Streaming flagship: segmentation-BM flow over a frame iterable,
    PIPELINED — each frame's device stages are dispatched before the
    previous frame's outputs are fetched
    (:func:`tpuflow.solvers.bm_flow.optical_flow_block_matching_async`),
    so the output fetch and host labeling hide behind device work.

    Yields :class:`BMFlowOutput` per frame pair, lagged one frame by
    the dispatch-ahead pipeline: pair (f0, f1)'s output is yielded when
    frame f2 arrives (or the iterable ends), so first-result latency is
    three frames. From the second pair on the estimate is bidirectional
    for the middle frame, like the reference's frame loop
    (Scratch_MeaningfulMotion.cpp:544-552). ``driver_kwargs`` pass
    through to the driver (iter_max, search_range, kernel_spatial,
    kernel_intensity, subpixel_scale, mesh, bm_method, mode, param).

    ``prewarm=True`` (default) launches a background thread after the
    first pair that compiles the plausible neighbor region-count
    buckets (and the steady-state bidirectional programs for the
    current one) while the early pairs stream — real sequences drift
    across matcher.region_bucket rungs, and each fresh rung otherwise
    costs a 10-20 s mid-stream compile
    (:func:`tpuflow.blockmatching.prewarm.prewarm_flagship`; the
    reference binary never recompiles, Scratch_MeaningfulMotion.cpp:79).

    A capability the reference only offers for image sequences via the
    CLI — this is its VideoDenseOF-style loop for the flagship path.
    """
    from tpuflow.solvers.bm_flow import optical_flow_block_matching_async

    tel = get_telemetry()
    state = None
    pending = None
    pending_frame = -1
    prev = None
    warmed = False
    for i, frame in enumerate(frames):
        frame = np.asarray(frame)
        if prev is not None:
            finalize, state = optical_flow_block_matching_async(
                prev, frame, max_int, state=state, **driver_kwargs)
            if prewarm and not warmed and driver_kwargs.get("mesh") is None:
                warmed = True
                from tpuflow.blockmatching.prewarm import prewarm_flagship

                import inspect

                from tpuflow.core.config import (
                    MODE_OUTPUT_AFFINE_BLOCKMATCHING,
                    MultipleMotionParam,
                )

                # Warmed programs must have the EXACT jit signature the
                # driver will request — read unspecified knobs from the
                # driver's own signature defaults instead of copying
                # literals that could drift.
                dflt = {k: p.default for k, p in inspect.signature(
                    optical_flow_block_matching_async).parameters.items()}

                def kw(name):
                    return driver_kwargs.get(name, dflt[name])

                param = driver_kwargs.get("param")
                # The batched zero-warp refine is the steady-state
                # program only for the default gradient branch; the
                # driver picks the affine branch on EXACT mode equality
                # (bm_flow.optical_flow_block_matching_async).
                plain_refine = (
                    not kw("refine_warp")
                    and kw("mode") != MODE_OUTPUT_AFFINE_BLOCKMATCHING)
                prewarm_flagship(
                    frame.shape[:2],
                    state.segmentations[0].n_regions,
                    search_range=kw("search_range"),
                    subpixel_scale=kw("subpixel_scale"),
                    bm_method=kw("bm_method"),
                    profile=driver_kwargs.get("profile"),
                    include_refine=plain_refine,
                    refine_iter_max=kw("iter_max"),
                    error_min_threshold=(
                        param if param is not None
                        else MultipleMotionParam()).error_min_threshold,
                    refine_sup_mode=kw("refine_sup_mode"),
                    refine_plateau_rtol=kw("refine_plateau_rtol"))
            if pending is not None:
                out = pending()
                tel.event("stream.bm_flow", frame=pending_frame,
                          bidirectional=bool(out.bidirectional))
                yield out
            pending = finalize
            pending_frame = i
        prev = frame
    if pending is not None:
        out = pending()
        tel.event("stream.bm_flow", frame=pending_frame,
                  bidirectional=bool(out.bidirectional))
        yield out


def dense_flow_stream_batched(
    frames: np.ndarray,
    pyr_scale: float = 0.4,
    levels: int = 1,
    winsize: int = 48,
    iterations: int = 2,
    poly_n: int = 8,
    poly_sigma: float = 1.2,
):
    """:func:`dense_flow_stream` with the frame loop ON DEVICE: one jit
    runs the whole (T, H, W) gray clip through ``lax.scan`` (carry = the
    previous frame, DenseFlow.cpp:51's warm state) and returns
    (u, v) stacks of shape (T-1, H, W).

    Serving rationale: a per-frame host loop pays a fixed dispatch cost
    per frame; scanning on device pays it once per clip. Same per-pair math as the generator (flags=0, zero initial
    flow, DenseFlow.cpp:37)."""
    import jax

    from tpuflow.solvers import calc_optical_flow_farneback

    frames = jnp.asarray(frames, jnp.float32)

    @jax.jit
    def run(stack):
        def body(prev, cur):
            u, v = calc_optical_flow_farneback(
                prev, cur, None, pyr_scale, levels, winsize, iterations,
                poly_n, poly_sigma, 0)
            return cur, (u, v)

        _, (us, vs) = jax.lax.scan(body, stack[0], stack[1:])
        return us, vs

    return run(frames)


# ---------------------------------------------------------------------------
# Sparse feature tracking


@dataclass
class TrackingState:
    points: np.ndarray | None = None       # (N, 2) active tracks
    initial: np.ndarray | None = None      # seed positions of the tracks
    prev_gray: np.ndarray | None = None


def feature_tracking_stream(
    frames: Iterable[np.ndarray],
    max_count: int = 500,
    quality_level: float = 0.01,
    min_distance: float = 10.0,
    min_track_count: int = 10,
    min_motion: float = 2.0,
    win: int = 21,
    max_level: int = 3,
    state: TrackingState | None = None,
):
    """Yields (gray, points, prev_points, status) per tracked frame
    (VideoFeaturesOF tracking(), FeaturesOpticalFlow.cpp:85-130). To
    reproduce the reference's per-frame display (red track lines +
    radius-3 green dots, FeaturesOpticalFlow.cpp:120-121), render each
    yield with :func:`tpuflow.viz.quiver.draw_tracks_cv`."""
    from tpuflow.solvers import (
        accept_tracked_point,
        good_features_to_track,
        track_points,
    )

    if state is None:
        state = TrackingState()
    tel = get_telemetry()
    for i, frame in enumerate(frames):
        if frame.ndim == 3:
            gray = np.asarray(rgb_to_gray(jnp.asarray(frame, jnp.float64)))
        else:
            gray = np.asarray(frame, np.float64)

        n_active = 0 if state.points is None else len(state.points)
        if n_active <= min_track_count:
            # addNewPoints (LucasKanadeOF.cpp:104-109)
            seeds = good_features_to_track(
                jnp.asarray(gray), max_count, quality_level, min_distance)
            if state.points is None or n_active == 0:
                state.points = seeds
                state.initial = seeds.copy()
            elif len(seeds):
                state.points = np.concatenate([state.points, seeds])[:max_count]
                state.initial = np.concatenate(
                    [state.initial, seeds])[:max_count]
            tel.event("stream.reseed", frame=i, count=len(state.points))

        if state.prev_gray is not None and state.points is not None \
                and len(state.points):
            new_pts, status = track_points(
                jnp.asarray(state.prev_gray), jnp.asarray(gray),
                state.points, win=win, max_level=max_level)
            new_pts = np.asarray(new_pts)
            accept = np.asarray(accept_tracked_point(
                state.points, new_pts, status, min_motion))
            prev_pts = state.points
            state.points = new_pts[accept]
            state.initial = state.initial[accept]
            tel.event("stream.track", frame=i, kept=int(accept.sum()),
                      total=len(new_pts))
            yield gray, state.points, prev_pts[accept], accept
        state.prev_gray = gray
