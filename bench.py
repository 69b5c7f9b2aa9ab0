"""Framework benchmark: one JSON line per headline workload.

The reference publishes no numbers; where an OpenCV-CPU equivalent of
the same math exists it is the baseline (vs_baseline = CPU time / device
time), otherwise the pinned f64 oracle's extrapolated cost, or null.

Workloads (reference budget citations in each runner):
- dense 1080p Horn-Schunck, 100 iters, 5x5 (HornSchunckOF/main.cpp:94-96)
- dense Farneback, streaming config (0.4,1,48,2,8,1.2) at 1080p
  (VideoDenseOF/DenseFlow.cpp:37)
- dense Farneback, pair-demo config (0.5,1,64,2,8,1.6) at KITTI res
  (FarnebackOF/FarnebackOF.cpp:24)
- Black-Anandan fused coarse-to-fine at KITTI res (1242x375)
  (OpticalFlow/OpticalFlow.cpp:131 budget, capped per level)
- flagship segmentation-BM driver steady state at KITTI res, full
  reference defaults (OpticalFlow_BlockMatching.cpp:32-33), on seeded
  synthetic layered frames (tpuflow.core.synthetic)
- 1-device weak-scaling row (tpuflow.dist.scaling harness)
- 4K Horn-Schunck (domain-size scaling, SURVEY.md §5.7)

The LAST line is the headline HS metric. Every row names the device it
ran on; the benchmark refuses to run without a GPU. A failing row ends
the run with its exception.
"""

from __future__ import annotations

import json
import time

import numpy as np

H, W = 1080, 1920
KH, KW = 375, 1242  # KITTI frame size
ITERS = 100
WINDOW = 5
ALPHA = 1.0


def emit(metric, value, unit, vs_baseline=None):
    import jax

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": metric,
        "value": float(value),
        "unit": unit,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": (float(vs_baseline) if vs_baseline is not None
                        and np.isfinite(vs_baseline) else None),
    }), flush=True)


def timed(run, repeats=20, windows=3):
    import jax

    out = run()
    jax.block_until_ready(out)
    np.asarray(jax.tree_util.tree_leaves(out)[0])
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = run()
        jax.block_until_ready(out)
        np.asarray(jax.tree_util.tree_leaves(out)[0])
        best = min(best, (time.perf_counter() - t0) / repeats)
    return best


def timed_scan(fn, pairs, windows=3):
    """Per-frame time of ``fn(prev, next)`` with the frame loop INSIDE
    one jit (lax.scan over a stacked (B, 2, H, W) batch, outputs reduced
    to a checksum): the device rate without per-call dispatch."""
    import jax
    import jax.numpy as jnp

    B = pairs.shape[0]

    @jax.jit
    def run(pairs):
        def body(c, pn):
            out = fn(pn[0], pn[1])
            s = sum(jnp.sum(o) for o in jax.tree_util.tree_leaves(out))
            return c + s.astype(jnp.float32), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), pairs)
        return acc

    np.asarray(run(pairs))  # compile + warm
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        np.asarray(run(pairs))
        best = min(best, (time.perf_counter() - t0) / B)
    return best


def _stack_pairs(prev, nxt, b=10):
    """B frame-pair variants (shifted copies — same work, distinct
    data)."""
    ps = np.stack([np.roll(prev, i, axis=1) for i in range(b)])
    ns = np.stack([np.roll(nxt, i, axis=1) for i in range(b)])
    return np.stack([ps, ns], axis=1)  # (B, 2, H, W)


def _frames_1080p():
    rng = np.random.default_rng(0)
    prev = rng.uniform(0, 255, (H, W))
    nxt = np.roll(prev, 2, axis=1) + rng.normal(0, 1, (H, W))
    return prev, nxt


def _frames_kitti():
    rng = np.random.default_rng(1)
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.uniform(0, 255, (KH + 8, KW + 8)), 2.0)
    return base[:KH, :KW].copy(), base[4 : 4 + KH, 2 : 2 + KW].copy()


def bench_horn_schunck():
    prev, nxt = _frames_1080p()
    import jax.numpy as jnp

    from tpuflow.solvers import horn_schunck

    pairs = jnp.asarray(_stack_pairs(prev, nxt), jnp.float32)
    dt = timed_scan(
        lambda a, b: horn_schunck(a, b, WINDOW, ITERS, ALPHA), pairs)

    vs = None
    try:
        import cv2

        pd = prev.astype(np.float64)
        nd = nxt.astype(np.float64)
        gx = cv2.Sobel(pd, -1, 1, 0, ksize=3)
        gy = cv2.Sobel(pd, -1, 0, 1, ksize=3)
        gt = nd - pd
        denom = ALPHA**2 + gx * gx + gy * gy
        k = np.ones((WINDOW, WINDOW), np.float64) / WINDOW**2
        u = np.zeros_like(gt)
        v = np.zeros_like(gt)
        # Best of 3 windows: the CPU baseline is host-load-sensitive
        # and a single window swung vs_baseline ~2x between runs.
        cpu_best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(10):
                ub = cv2.filter2D(u, -1, k,
                                  borderType=cv2.BORDER_CONSTANT)
                vb = cv2.filter2D(v, -1, k,
                                  borderType=cv2.BORDER_CONSTANT)
                upd = (gx * ub + gy * vb + gt) / denom
                u = ub - gx * upd
                v = vb - gy * upd
            cpu_best = min(cpu_best, (time.perf_counter() - t0) / 10)
        vs = cpu_best * ITERS / dt
    except Exception:
        pass
    return 1.0 / dt, vs


def _bench_farneback_cfg(prev, nxt, cfg, b=5):
    """Device rate of one Farneback config + the OpenCV-CPU baseline."""
    import jax.numpy as jnp

    from tpuflow.solvers import calc_optical_flow_farneback

    pairs = jnp.asarray(_stack_pairs(prev, nxt, b=b), jnp.float32)
    dt = timed_scan(
        lambda a, b: calc_optical_flow_farneback(a, b, None, **cfg), pairs)
    vs = None
    try:
        import cv2

        pf = prev.astype(np.float32)
        nf = nxt.astype(np.float32)
        cv2.calcOpticalFlowFarneback(pf, nf, None, **cfg)
        t0 = time.perf_counter()
        for _ in range(3):
            cv2.calcOpticalFlowFarneback(pf, nf, None, **cfg)
        vs = ((time.perf_counter() - t0) / 3) / dt
    except Exception:
        pass
    return 1.0 / dt, vs


def bench_farneback():
    """Streaming Farneback (DenseFlow.cpp:37 config) at 1080p."""
    prev, nxt = _frames_1080p()
    cfg = dict(pyr_scale=0.4, levels=1, winsize=48, iterations=2,
               poly_n=8, poly_sigma=1.2, flags=0)
    return _bench_farneback_cfg(prev, nxt, cfg)


def bench_farneback_demo():
    """Pair-demo Farneback (FarnebackOF.cpp:24 config: 0.5, 1, 64, 2,
    8, 1.6) at the demo's own corpus resolution (KITTI 1242x375)."""
    prev, nxt = _frames_kitti()
    cfg = dict(pyr_scale=0.5, levels=1, winsize=64, iterations=2,
               poly_n=8, poly_sigma=1.6, flags=0)
    return _bench_farneback_cfg(prev, nxt, cfg, b=5)


def bench_farneback_demo3():
    """HS-demo comparison Farneback (HornSchunckOF/main.cpp:111 config:
    0.5, 3, 15, 3, 5, 1.2) at 1080p — the one MULTI-LEVEL production
    config; its warped updates are the hot spot."""
    prev, nxt = _frames_1080p()
    cfg = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
               poly_n=5, poly_sigma=1.2, flags=0)
    return _bench_farneback_cfg(prev, nxt, cfg, b=5)


def bench_farneback_demo3_largemotion():
    """The same multi-level config on a GENUINELY large-motion input
    (~16 px pan + a moving block, flow far beyond the dense-warp bound
    at every level): the warped updates take the exact large-motion
    path: the per-tile integer pre-shift warp with per-tile gather
    fallback at motion boundaries."""
    base = _multioctave_frames(16)
    prev = base[:, :W].copy()
    nxt = base[:, 16 : 16 + W].copy()  # 16-px global pan
    # A counter-moving foreground block forces motion-boundary tiles
    # (the per-tile gather fallback path) into the measurement too.
    nxt[400:700, 300:800] = prev[392:692, 310:810]
    cfg = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
               poly_n=5, poly_sigma=1.2, flags=0)
    return _bench_farneback_cfg(prev, nxt, cfg, b=5)


def _multioctave_frames(margin: int):
    """TRACKABLE large-motion texture: multi-octave smoothed noise, so
    the pyramid's coarse levels have real structure to lock onto (a
    single-octave gf(1.5) noise pan is untrackable at 24 px — the
    solver never converges and the 'flow' is boundary-free garbage,
    which is the wrong workload for the large-motion warp)."""
    rng = np.random.default_rng(9)
    from scipy.ndimage import gaussian_filter

    shape = (H, W + margin + 40)

    def octave(sigma):
        # Unit-variance octaves: gaussian_filter shrinks the noise's
        # std by ~sigma, so unnormalized coarse octaves carry almost
        # no contrast and the pyramid's top level cannot lock on
        # (measured: the solver left 97% of a 24 px pan untracked).
        g = gaussian_filter(rng.uniform(0, 1, shape), sigma)
        return (g - g.mean()) / g.std()

    base = octave(2) + octave(8) + octave(32)
    base -= base.min()
    return base * (255.0 / base.max())


def _oracles():
    """tests/oracles.py (the pinned f64 NumPy re-derivation of the
    reference C++ math) as an importable module — the CPU baseline for
    the metrics whose reference build cannot run (missing submodules,
    SURVEY.md §0)."""
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    return importlib.import_module("oracles")


def _ba_oracle_spf():
    """Extrapolated pinned-oracle cost of the benched BA solve (6 levels
    x 512 capped iters at KITTI res): per-sweep + per-energy f64 oracle
    time measured at level-0 resolution, scaled by the exact pixel ratio
    sum over levels (1/4 per level) and the 64-iter energy cadence."""
    orc = _oracles()
    rng = np.random.default_rng(3)
    gx = rng.normal(size=(KH, KW))
    gy = rng.normal(size=(KH, KW))
    it = 0.1 * rng.normal(size=(KH, KW))
    u = np.zeros((KH, KW))
    v = np.zeros((KH, KW))
    t0 = time.perf_counter()
    for _ in range(4):
        u, v = orc.irls_sweep_oracle(u, v, gx, gy, it, 5.0, 1.0, 0.14,
                                     0.02, 1e4, 1e4)
    t_sweep = (time.perf_counter() - t0) / 4
    t0 = time.perf_counter()
    orc.irls_energy_oracle(u, v, gx, gy, it, 5.0, 1.0, 0.14, 0.02)
    t_energy = time.perf_counter() - t0
    s = sum(0.25**lv for lv in range(6))  # level pixel-count ratios
    return (512 * t_sweep + 8 * t_energy) * s


def _flagship_oracle_spf():
    """Extrapolated pinned-f64-oracle cost of ONE flagship frame-pair at
    KITTI res. Stage costs measured on reduced work and scaled by exact
    op-count ratios (every stage is embarrassingly data-parallel):
    mean-shift filter (8 iters x 41x41 window offsets, full frame),
    bidirectional 61x61 region BM search with per-region bincount
    reductions, and 2 x 2048 region-gated IRLS sweeps."""
    orc = _oracles()
    rng = np.random.default_rng(7)
    h, w = KH, KW

    # Mean-shift filter: 64 of the 1681 window offsets of one of the 8
    # iterations, at 1/4 the pixels -> scale (1681/64) * 8 * 4.
    ch, cw = h // 2, w // 2
    lab = rng.uniform(0, 1, (ch, cw, 3))
    ex = np.zeros((ch, cw))
    ey = np.zeros((ch, cw))
    acc = [np.zeros((ch, cw)) for _ in range(6)]
    t0 = time.perf_counter()
    for k in range(64):
        dy, dx = k // 8 - 4, k % 8 - 4
        sh = np.roll(lab, (dy, dx), axis=(0, 1))
        d2 = ((sh - lab) ** 2).sum(-1)
        m = (d2 <= 0.0039) & ((ex + dx) ** 2 + (ey + dy) ** 2 <= 400.0)
        for i in range(3):
            acc[i] += np.where(m, sh[..., i], 0.0)
        acc[3] += m * dx
        acc[4] += m * dy
        acc[5] += m
    t_ms = (time.perf_counter() - t0) * (1681 / 64) * 8 * 4

    # BM search: 16 of ~3821 candidate evaluations (3721 full-pel +
    # ~100 full-pel-equivalents of x2-subpixel refinement) per
    # direction, x2 directions.
    cur = rng.normal(size=(h, w))
    ref = rng.normal(size=(h, w))
    labels = rng.integers(0, 346, (h, w))
    flat = labels.ravel()
    t0 = time.perf_counter()
    for k in range(16):
        dy, dx = k // 4 - 2, k % 4 - 2
        sh = np.roll(ref, (dy, dx), axis=(0, 1))
        mad = np.abs(sh - cur)
        prod = sh * cur
        np.bincount(flat, weights=mad.ravel(), minlength=346)
        np.bincount(flat, weights=prod.ravel(), minlength=346)
    t_bm = (time.perf_counter() - t0) * (3821 / 16) * 2

    # Region-gated IRLS refine: 4 measured sweeps -> 2048 x 2 directions.
    gx = rng.normal(size=(h, w))
    gy = rng.normal(size=(h, w))
    it = 0.1 * rng.normal(size=(h, w))
    u = np.zeros((h, w))
    v = np.zeros((h, w))
    t0 = time.perf_counter()
    for _ in range(4):
        u, v = orc.gated_irls_sweep_oracle(
            u, v, gx, gy, it, labels, 5.0, 1.0, 0.14, 0.02, 1e4, 1e4)
    t_irls = (time.perf_counter() - t0) / 4 * 2048 * 2

    return t_ms + t_bm + t_irls


def bench_black_anandan():
    """Fused coarse-to-fine Black-Anandan at KITTI res, 5 levels,
    iteration budget capped at 512/level (the full reference budget is
    (level+1)*10*1242 — throughput-normalized here). vs_baseline: the
    pinned f64 NumPy oracle (same math/constants as the reference C++,
    whose own build cannot run) extrapolated to the same budget."""
    import jax.numpy as jnp

    from tpuflow.core.config import MultipleMotionParam
    from tpuflow.solvers.black_anandan_fast import optical_flow_pyramid_fast

    prev, nxt = _frames_kitti()
    param = MultipleMotionParam(level=5)
    pairs = jnp.asarray(_stack_pairs(prev, nxt, b=5), jnp.float32)
    dt = timed_scan(
        lambda a, b: optical_flow_pyramid_fast(
            a, b, 255.0, param, iter_max=512, fuse=16)[:2], pairs)
    vs = None
    try:
        vs = _ba_oracle_spf() / dt
    except Exception:
        pass
    return 1.0 / dt, vs


def _frames_flagship():
    """Flagship bench frames: four RGB frames at KITTI res of the seeded
    layered scene (tpuflow.core.synthetic; textured background pan plus
    an occluding foreground box, texture coarse enough to segment into a
    KITTI-like region count)."""
    from tpuflow.core.synthetic import layered_scene

    scene = layered_scene(KH, KW, seed=7, bg=(3.0, 1.0), fg=(-4.0, 2.0),
                          channels=3, periods=(12.0, 192.0))
    return [scene.frame(t) for t in range(4)]


def bench_bm_flagship(bm_method="matmul", mesh=None, with_baseline=True,
                      profile=None):
    """Flagship driver, FULL reference defaults, PIPELINED steady state
    on the synthetic KITTI-res frames: the sequence loop dispatches frame i+1 before
    finalizing frame i (optical_flow_block_matching_async), so each
    frame's output fetch and host labeling hide behind the next frame's
    device work — how a production frame loop runs.
    ``bm_method="matmul_bf16"`` benches the bf16-input search
    evaluator; ``mesh=`` routes every device
    stage through the sharded (shard_map) programs. vs_baseline: the
    pinned-oracle CPU proxy (:func:`_flagship_oracle_spf`)."""
    from tpuflow.solvers.bm_flow import optical_flow_block_matching_async

    frames = _frames_flagship()
    cyc = len(frames)
    # Continuous sequence: warmup covers the cold first pair + one full
    # cycle (every region-count bucket compiles once), then best-of-2
    # one-cycle windows.
    seq = [frames[i % cyc] for i in range(3 * cyc + 2)]

    def run_pairs(state, frames_, pending):
        """Dispatch each pair, finalizing the previous pair's output
        only after the next dispatch is queued."""
        for a, b in zip(frames_[:-1], frames_[1:]):
            fin, state = optical_flow_block_matching_async(
                a, b, 255.0, iter_max=2048, state=state,
                bm_method=bm_method, mesh=mesh, profile=profile)
            if pending is not None:
                pending()
            pending = fin
        return state, pending

    state, pending = run_pairs(None, seq[: cyc + 2], None)
    best = float("inf")
    for k in range(2):
        lo = cyc + 1 + k * cyc
        t0 = time.perf_counter()
        state, pending = run_pairs(state, seq[lo : lo + cyc + 1], pending)
        best = min(best, (time.perf_counter() - t0) / cyc)
    pending()
    vs = None
    if with_baseline:
        try:
            vs = _flagship_oracle_spf() / best
        except Exception:
            pass
    return best, vs


def bench_hs_4k():
    """Domain-size scaling (SURVEY.md §5.7's long-context analogue):
    the same 100-iter 5x5 Horn-Schunck on a 3840x2160 frame — one
    device, 4x the 1080p pixel count. Baseline: the OpenCV-CPU loop at
    4K (10 iterations measured, linearly scaled to the 100-iteration
    budget)."""
    import jax.numpy as jnp

    from tpuflow.solvers import horn_schunck

    rng = np.random.default_rng(4)
    prev = rng.uniform(0, 255, (2160, 3840))
    nxt = np.roll(prev, 2, axis=1) + rng.normal(0, 1, (2160, 3840))
    pairs = jnp.asarray(_stack_pairs(prev, nxt, b=3), jnp.float32)
    dt = timed_scan(
        lambda a, b: horn_schunck(a, b, WINDOW, ITERS, ALPHA), pairs,
        windows=2)
    vs = None
    try:
        import cv2

        pd = prev.astype(np.float64)
        gx = cv2.Sobel(pd, -1, 1, 0, ksize=3)
        gy = cv2.Sobel(pd, -1, 0, 1, ksize=3)
        gt = nxt.astype(np.float64) - pd
        denom = ALPHA**2 + gx * gx + gy * gy
        k = np.ones((WINDOW, WINDOW), np.float64) / WINDOW**2
        u = np.zeros_like(gt)
        v = np.zeros_like(gt)
        t0 = time.perf_counter()
        for _ in range(10):
            ub = cv2.filter2D(u, -1, k, borderType=cv2.BORDER_CONSTANT)
            vb = cv2.filter2D(v, -1, k, borderType=cv2.BORDER_CONSTANT)
            upd = (gx * ub + gy * vb + gt) / denom
            u = ub - gx * upd
            v = vb - gy * upd
        vs = (time.perf_counter() - t0) / 10 * ITERS / dt
    except Exception:
        pass
    return 1.0 / dt, vs


def bench_weak_scaling_row():
    """1-device fused-sharded-HS device rate by two-point timing.

    Times 100- and 300-iteration solves and divides the extra 200
    iterations by the time delta: dispatch, the gradient pre-pass and
    the result fetch are identical in both and cancel, leaving the pure
    sweep rate. The iteration count is a RUNTIME operand
    (horn_schunck_sharded_fused_dynamic) so both points share one
    compiled program."""
    import jax
    from jax.sharding import NamedSharding

    from tpuflow.dist.mesh import make_mesh
    from tpuflow.dist.solvers import (
        SPEC,
        horn_schunck_sharded_fused_dynamic,
    )

    th, tw = 512, 1024
    mesh = make_mesh(1)
    rng = np.random.default_rng(0)
    prev = rng.uniform(0, 255, (th, tw)).astype(np.float32)
    sharding = NamedSharding(mesh, SPEC)
    prev_d = jax.device_put(prev, sharding)
    nxt_d = jax.device_put(np.roll(prev, 2, axis=1), sharding)

    def run(iters):
        u, _ = horn_schunck_sharded_fused_dynamic(
            prev_d, nxt_d, mesh, 5, iters, 1.0, 10)
        return u

    def measure(iters, repeats=4):
        np.asarray(run(iters)[:1, :1])  # compile + sync
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(repeats):
                u = run(iters)
            np.asarray(u[:1, :1])
            best = min(best, (time.perf_counter() - t0) / repeats)
        return best

    t100 = measure(100)
    t300 = measure(300)
    rate = th * tw * 200 / max(t300 - t100, 1e-9) / 1e6
    return {"mpix_per_s": rate, "seconds_100": t100, "seconds_300": t300}


def main() -> None:
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench.py measures the GPU; JAX found "
                         f"{jax.devices()[0].platform!r}")

    def row(name, unit, fn):
        res = fn()
        value, vs = res if isinstance(res, tuple) else (res, None)
        emit(name, value, unit, vs)

    row("farneback_stream_1080p_fps",
        "frames/s (Farneback 0.4/1/48/2/8/1.2, f32, 1080p)",
        bench_farneback)
    row("farneback_demo_kitti_fps",
        "frames/s (Farneback 0.5/1/64/2/8/1.6, f32, 1242x375)",
        bench_farneback_demo)
    row("farneback_demo3_1080p_fps",
        "frames/s (Farneback 0.5/3/15/3/5/1.2 MULTI-LEVEL, f32, 1080p; "
        "small-motion frames take the runtime-adaptive dense warp)",
        bench_farneback_demo3)
    row("farneback_demo3_largemotion_fps",
        "frames/s (same MULTI-LEVEL config, ~16 px pan + counter-moving "
        "block — every warped update takes the exact large-motion path: "
        "per-tile integer pre-shift warp with per-tile gather fallback "
        "at motion boundaries)",
        bench_farneback_demo3_largemotion)
    row("black_anandan_kitti_fps",
        "frames/s (5-level fused IRLS pyramid, iter_max 512/level, "
        "1242x375; baseline: pinned f64 NumPy oracle, same budget, "
        "op-count-extrapolated)",
        bench_black_anandan)
    row("bm_flagship_kitti_spf",
        "s/frame-pair PIPELINED steady state on synthetic layered RGB "
        "frames, best-of-2 4-pair windows (mean-shift R=20 + "
        "bidirectional 61x61 BM + subpixel + gated IRLS, reference "
        "defaults; frame i+1 dispatched before frame i's fetch; "
        "baseline: pinned-oracle CPU proxy, op-count-extrapolated)",
        bench_bm_flagship)
    row("bm_flagship_coarse_spf",
        "s/frame-pair, same workload with the stride-2 coarse search "
        "+ inclusive +-1 sorted-tap local refinement "
        "(bm_method=matmul_coarse — NOT bit-faithful to the "
        "exhaustive search)",
        lambda: bench_bm_flagship(bm_method="matmul_coarse",
                                  with_baseline=False))
    row("bm_flagship_fast_spf",
        "s/frame-pair, same workload under profile=fast (stride-2 "
        "coarse search + analytic-bound plateau-stopped refine — NOT "
        "bit-faithful)",
        lambda: bench_bm_flagship(profile="fast", with_baseline=False))
    row("bm_flagship_turbo_spf",
        "s/frame-pair, same workload under profile=turbo (fast + "
        "half-res segmentation)",
        lambda: bench_bm_flagship(profile="turbo", with_baseline=False))
    row("bm_flagship_sharded_1dev_spf",
        "s/frame-pair, same workload routed through the sharded "
        "(shard_map) device programs on a 1-device mesh",
        lambda: bench_bm_flagship(
            mesh=__import__("tpuflow.dist.mesh",
                            fromlist=["make_mesh"]).make_mesh(1)))
    row("weak_scaling_1dev",
        "Mpix*iter/s on 1 device (fused sharded HS, 512x1024 tile)",
        lambda: bench_weak_scaling_row()["mpix_per_s"])
    row("hs_dense_4k_fps",
        "frames/s (100-iter 5x5 Horn-Schunck, f32, 3840x2160)",
        bench_hs_4k)
    # Headline metric LAST.
    row("hs_dense_1080p_fps",
        "frames/s (100-iter 5x5 Horn-Schunck, f32)",
        bench_horn_schunck)


if __name__ == "__main__":
    main()
