#!/usr/bin/env python3
"""Smoke run of tpuflow's main paths on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: every single-device phase
    python chip_smoke.py --devices 4  # the multi-device path on 4 GPUs

Every phase goes through the entry points a user calls, at the sizes
users run, on seeded synthetic frames with known motion
(tpuflow.core.synthetic). Each phase prints its compile time, its
steady-state time and its errors beside their tolerances. CPU references
(the float64 NumPy oracles of tests/oracles.py, and the same calls on
JAX's CPU backend) run in one child process that pins JAX to the CPU
before importing it, so this process is the only one on the card. The
multi-device path is compared with the same calls on one GPU.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A failed phase or an error over its tolerance exits non-zero without it.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
KITTI = (375, 1242)
HD = (1080, 1920)
UHD = (2160, 3840)

# Frame sets: (h, w, seed, bg motion, fg motion, channels, texture
# periods); both this process and the CPU reference child render them
# from these seeds. The flagship scenes' coarser textures segment into
# KITTI-like region counts (~1100 and ~2200).
FINE, COARSE, MID = (6.0, 96.0), (12.0, 192.0), (10.0, 160.0)
SCENES = {
    "hs_1080p": (*HD, 21, (1.0, 0.5), (-2.0, 1.0), 1, FINE),
    "hs_4k": (*UHD, 22, (1.0, 0.5), (-2.0, 1.0), 1, FINE),
    "fb_stream": (*HD, 23, (1.5, 0.5), (-1.0, 1.0), 1, FINE),
    "fb_large": (*HD, 24, (12.0, 4.0), (-6.0, 6.0), 1, FINE),
    "ba": (*KITTI, 25, (1.0, 0.5), (-2.0, 1.0), 1, FINE),
    "bm": (*KITTI, 26, (3.0, 1.0), (-4.0, 2.0), 3, COARSE),
    "bm_cut": (*KITTI, 26, (-2.0, 2.0), (3.0, -1.0), 3, MID),
    "lk": (*KITTI, 28, (2.0, 1.0), (-3.0, 1.5), 1, FINE),
    "bm_hd": (*HD, 29, (3.0, 1.0), (-4.0, 2.0), 3, COARSE),  # --devices 4
}
HS_ITERS, HS_WINDOW = 100, 5
FB_STREAM = dict(pyr_scale=0.4, levels=1, winsize=48, iterations=2,
                 poly_n=8, poly_sigma=1.2)          # DenseFlow.cpp:37
FB_MULTI = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                poly_n=5, poly_sigma=1.2)           # HornSchunckOF/main.cpp:111
BA_LEVELS, BA_ITER_SCALE, BA_FUSE = 4, 0.005, 16
BM_ITERS = 2048
STREAM_FRAMES = 6


def scene(name):
    from tpuflow.core.synthetic import layered_scene

    h, w, seed, bg, fg, ch, periods = SCENES[name]
    return layered_scene(h, w, seed, bg, fg, ch, periods)


def bm_frames():
    """Flagship sequence: four frames of one scene, then a cut to a
    second scene for two frames (the region count changes bucket)."""
    a, b = scene("bm"), scene("bm_cut")
    return [a.frame(t) for t in range(4)] + [b.frame(t) for t in range(2)]


def with_scratch(frame):
    """A film scratch: a dark 1-px vertical line at 2/5 of the width."""
    out = frame.copy()
    out[:, frame.shape[1] * 2 // 5] = 20.0
    return out


def hs_fused(prev, next, window_size=HS_WINDOW, max_iterations=HS_ITERS,
             alpha=1.0, fuse=5):
    """Horn-Schunck in plain jnp as blocks of ``fuse`` shifted-add sweeps
    (tpuflow.ops.stencil.hs_sweeps) on the frame zero-padded by the
    block's halo: the faster plain baseline the CUDA kernel is timed
    against (the other is solvers.horn_schunck_conv)."""
    return _hs_fused_jit()(prev, next, window_size=window_size,
                           max_iterations=max_iterations, alpha=alpha,
                           fuse=fuse)


@functools.cache
def _hs_fused_jit():
    import jax
    import jax.numpy as jnp

    from tpuflow.ops.stencil import hs_sweeps, inside_mask
    from tpuflow.solvers.horn_schunck import hs_gradients

    @functools.partial(jax.jit, static_argnames=(
        "window_size", "max_iterations", "fuse"))
    def run(prev, next, window_size, max_iterations, alpha, fuse):
        gx, gy, gt = hs_gradients(prev, next)
        inv = 1.0 / (alpha * alpha + gx * gx + gy * gy)
        h, w = gx.shape
        r = window_size // 2

        def block(u, v, k):
            hk = k * r
            pad = lambda a: jnp.pad(a, hk)  # noqa: E731
            mask = inside_mask(-hk, -hk, h + 2 * hk, w + 2 * hk, h, w,
                               gx.dtype)
            return hs_sweeps(pad(u), pad(v), pad(gx), pad(gy), pad(gt),
                             pad(inv), mask, window_size, k)

        u = v = jnp.zeros_like(gt)
        n_full, rem = divmod(max_iterations, fuse)
        if n_full:
            u, v = jax.lax.fori_loop(
                0, n_full, lambda _, uv: block(*uv, fuse), (u, v))
        if rem:
            u, v = block(u, v, rem)
        return u, v

    return run


# ---------------------------------------------------------------------------
# CPU reference child (no GPU: JAX_PLATFORMS=cpu is set before import).


def cpu_reference(out_path: str) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(REPO / "tests"))
    from oracles import horn_schunck_oracle, optical_flow_pyramid_oracle

    res = {}
    for name in ("hs_1080p", "hs_4k"):
        s = scene(name)
        u, v = horn_schunck_oracle(s.frame(0), s.frame(1), HS_WINDOW,
                                   HS_ITERS, 1.0)
        res[f"{name}_u"], res[f"{name}_v"] = u, v
    s = scene("ba")
    for key, fuse in (("ba_plain", None), ("ba_fast", BA_FUSE)):
        u, v = optical_flow_pyramid_oracle(
            s.frame(0), s.frame(1), 255.0, BA_LEVELS,
            iter_scale=BA_ITER_SCALE, fuse=fuse)
        res[f"{key}_u"], res[f"{key}_v"] = u, v
    jax.config.update("jax_enable_x64", False)  # the same f32 calls
    for key, fn in cpu_calls().items():
        for i, a in enumerate(fn()):
            res[f"{key}_{i}"] = np.asarray(a)
    np.savez(out_path, **res)


def cpu_calls():
    """The calls whose CPU-backend results the GPU run is compared with
    (keyed; each returns a tuple of arrays)."""
    return {
        "fb_stream": lambda: fb_pair("fb_stream", FB_STREAM),
        "fb_large": lambda: fb_pair("fb_large", FB_MULTI),
        "bm": lambda: flagship_pair(scene("bm"), None),
        "lk": lambda: lk_run(3)[-1][:2],
    }


def fb_pair(name, cfg):
    from tpuflow.pipeline.streaming import dense_flow_stream

    s = scene(name)
    (_, u, v), = dense_flow_stream([s.frame(0), s.frame(1)],
                                   working_size=None, **cfg)
    return u, v


def flagship_pair(s, mesh):
    from tpuflow.solvers.bm_flow import optical_flow_block_matching_async

    fin, _ = optical_flow_block_matching_async(
        s.frame(0), s.frame(1), 255.0, iter_max=BM_ITERS, mesh=mesh)
    out = fin()
    return (out.bm_u, out.bm_v, out.u, out.v,
            out.segmentation.labels.astype(np.int32))


def lk_run(n_frames):
    from tpuflow.pipeline.streaming import feature_tracking_stream

    s = scene("lk")
    return [(np.asarray(p), np.asarray(q), np.asarray(st)) for _, p, q, st
            in feature_tracking_stream(s.frame(t) for t in range(n_frames))]


def start_cpu_reference(tmp: Path):
    out = tmp / "cpu_reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import chip_smoke; chip_smoke.cpu_reference({str(out)!r})")
    log = open(tmp / "cpu_reference.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, out, log


def wait_cpu_reference(proc, out: Path, log) -> dict:
    rc = proc.wait()
    log.close()
    if rc != 0:
        sys.stdout.write(Path(log.name).read_text()[-4000:])
        raise RuntimeError(f"CPU reference child failed (exit {rc})")
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# Measurement and checks


class Report:
    def __init__(self):
        self.failures = []

    def time(self, label, fn, repeats=2):
        """Run ``fn`` once (compile + run) and ``repeats`` more times
        (steady state, median); returns the last result."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        steady = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            steady.append(time.perf_counter() - t0)
        med = float(np.median(steady)) if steady else float("nan")
        print(f"  {label}: first call {first:.3f} s (compile + run), "
              f"steady {med:.4f} s", flush=True)
        return out

    def check(self, label, value, tol, why):
        ok = bool(np.isfinite(value) and value <= tol)
        print(f"  {label} = {value:.3e} (tolerance {tol:.1e}: {why}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(label)


def epe(u, v, u0, v0, mask=None):
    e = np.hypot(np.asarray(u, np.float64) - u0,
                 np.asarray(v, np.float64) - v0)
    return e if mask is None else e[mask]


def interior(s, t, margin):
    """Pixels at least ``margin`` px from the frame and the fg box edges
    at frame t (where the true flow is defined without occlusion)."""
    m = np.zeros((s.h, s.w), bool)
    m[margin:-margin, margin:-margin] = True
    x0, y0, x1, y1 = s.box
    ox, oy = s.fg[0] * t, s.fg[1] * t
    ys = np.arange(s.h)[:, None] - oy
    xs = np.arange(s.w)[None, :] - ox
    near = ((ys > y0 - margin) & (ys < y1 + margin)
            & (xs > x0 - margin) & (xs < x1 + margin)
            & ~((ys >= y0 + margin) & (ys < y1 - margin)
                & (xs >= x0 + margin) & (xs < x1 - margin)))
    return m & ~near


def finite_shape(rep, label, arrays, shape):
    ok = all(np.asarray(a).shape == shape and np.isfinite(a).all()
             for a in arrays)
    print(f"  {label}: shape {shape}, finite: {'ok' if ok else 'FAIL'}")
    if not ok:
        rep.failures.append(label)


# ---------------------------------------------------------------------------
# Single-device phases


def phase_hs(rep, ref):
    import jax
    import jax.numpy as jnp

    from tpuflow.core import backend
    from tpuflow.solvers import horn_schunck, horn_schunck_conv

    variants = [("solvers.horn_schunck", horn_schunck),
                ("plain conv (horn_schunck_conv)", horn_schunck_conv),
                ("plain fused-5 (hs_fused)", hs_fused)]
    print(f"[hs] 100 sweeps 5x5; solvers.horn_schunck runs the "
          f"{'CUDA kernel' if backend.paths().hs_kernel else 'plain conv'}")
    for name in ("hs_1080p", "hs_4k"):
        s = scene(name)
        p = jnp.asarray(s.frame(0), jnp.float32)
        n = jnp.asarray(s.frame(1), jnp.float32)
        for label, fn in variants:
            u, v = rep.time(f"{name} {label}", lambda: fn(
                p, n, HS_WINDOW, HS_ITERS, 1.0))
            if ref is not None:
                e = epe(u, v, ref[f"{name}_u"], ref[f"{name}_v"])
                rep.check(f"{name} {label} max |flow - f64 oracle|",
                          float(e.max()), 1e-4,
                          "f32 vs f64; measured ~1e-6 on the CPU, TF32 "
                          "would give ~1e-2")
    s = scene("hs_1080p")
    p = jnp.asarray(s.frame(0), jnp.float32)
    n = jnp.asarray(s.frame(1), jnp.float32)
    for window in (3, 7):
        u, v = rep.time(f"hs_1080p window {window} solvers.horn_schunck",
                        lambda: horn_schunck(p, n, window, HS_ITERS, 1.0),
                        repeats=1)
        u1, v1 = horn_schunck_conv(p, n, window, HS_ITERS, 1.0)
        rep.check(f"window {window} max |horn_schunck - plain conv|",
                  float(epe(u, v, np.asarray(u1), np.asarray(v1)).max()),
                  1e-4, "f32 both, another sum order")

    # Batched callers: jax.vmap runs the kernel once per pair.
    pb, nb = jnp.stack([p, n]), jnp.stack([n, p])
    batched = jax.vmap(lambda a, b: horn_schunck(a, b, HS_WINDOW, HS_ITERS,
                                                 1.0))
    ub, vb = rep.time("hs_1080p jax.vmap(solvers.horn_schunck), batch of 2",
                      lambda: batched(pb, nb), repeats=1)
    for i in range(2):
        u1, v1 = horn_schunck(pb[i], nb[i], HS_WINDOW, HS_ITERS, 1.0)
        rep.check(f"vmap batch element {i} max |batched - unbatched|",
                  float(epe(ub[i], vb[i], np.asarray(u1),
                            np.asarray(v1)).max()),
                  1e-5, "same sweeps per pair; the batched gradient "
                  "convs may sum in another order")


def phase_farneback(rep, gpu):
    from tpuflow.pipeline.streaming import dense_flow_stream

    print("[farneback] pipeline.streaming.dense_flow_stream at 1920x1080")
    s = scene("fb_stream")
    frames = [s.frame(t) for t in range(STREAM_FRAMES)]
    t0 = time.perf_counter()
    times, outs = [], []
    for _, u, v in dense_flow_stream(frames, working_size=None, **FB_STREAM):
        times.append(time.perf_counter() - t0)
        outs.append((u, v))
        t0 = time.perf_counter()
    print(f"  stream (0.4,1,48,2,8,1.2), {STREAM_FRAMES} frames: first "
          f"pair {times[0]:.3f} s (compile + run), steady "
          f"{np.median(times[1:]):.4f} s/frame")
    for i, (u, v) in enumerate(outs):
        m = interior(s, i, 48)
        rep.check(f"stream pair {i} median EPE vs true flow",
                  float(np.median(epe(u, v, *s.flow(i), m))), 0.25,
                  "interior, >= winsize from occlusion edges")
    gpu["fb_stream"] = outs[0]

    s = scene("fb_large")
    pair = [s.frame(0), s.frame(1)]
    u, v = rep.time("multi-level (0.5,3,15,3,5,1.2) large motion", lambda: [
        o[1:] for o in dense_flow_stream(pair, working_size=None,
                                         **FB_MULTI)][0])
    rep.check("multi-level median EPE vs true flow (12 px pan)",
              float(np.median(epe(u, v, *s.flow(0), interior(s, 0, 32)))),
              0.5, "interior; tiled warp + gather fallback at the edges")
    gpu["fb_large"] = (u, v)


def phase_black_anandan(rep, ref):
    import jax.numpy as jnp

    from tpuflow.core.config import MultipleMotionParam
    from tpuflow.solvers import optical_flow_pyramid
    from tpuflow.solvers.black_anandan_fast import optical_flow_pyramid_fast

    print(f"[black-anandan] 1242x375, {BA_LEVELS + 1} levels, iter_scale "
          f"{BA_ITER_SCALE}")
    s = scene("ba")
    p = jnp.asarray(s.frame(0), jnp.float32)
    n = jnp.asarray(s.frame(1), jnp.float32)
    param = MultipleMotionParam(level=BA_LEVELS)
    runs = {
        "ba_plain": ("optical_flow_pyramid", lambda: optical_flow_pyramid(
            p, n, 255.0, param, iter_scale=BA_ITER_SCALE)),
        "ba_fast": ("optical_flow_pyramid_fast",
                    lambda: optical_flow_pyramid_fast(
                        p, n, 255.0, param, iter_scale=BA_ITER_SCALE,
                        fuse=BA_FUSE)),
    }
    for key, (label, fn) in runs.items():
        u, v = rep.time(label, fn, repeats=1)
        if ref is not None:
            e = epe(u, v, ref[f"{key}_u"], ref[f"{key}_v"])
            rep.check(f"{label} max |flow - f64 oracle|", float(e.max()),
                      1e-4, "f32 vs f64 (same stop cadence); ~6e-7 on the "
                      "CPU")


def phase_flagship(rep, gpu, tmp: Path):
    from tpuflow.blockmatching.matcher import region_bucket
    from tpuflow.solvers.bm_flow import optical_flow_block_matching_async

    print("[flagship] optical_flow_block_matching_async at 1242x375")
    frames = bm_frames()
    buckets = set()
    for profile in (None, "fast", "turbo"):
        state, pending, outs, times = None, None, [], []
        for a, b in zip(frames[:-1], frames[1:]):
            t0 = time.perf_counter()
            fin, state = optical_flow_block_matching_async(
                a, b, 255.0, iter_max=BM_ITERS, state=state, profile=profile)
            buckets.add(region_bucket(state.segmentations[0].n_regions))
            if pending is not None:
                outs.append(pending())
            pending = fin
            times.append(time.perf_counter() - t0)
        outs.append(pending())
        name = profile or "default"
        print(f"  profile {name}: {len(outs)} pairs; per dispatch + "
              f"previous fetch: first {times[0]:.2f} s (compile + run), "
              f"then {', '.join(f'{t:.3f}' for t in times[1:])} s")
        for i, out in enumerate(outs):
            finite_shape(rep, f"{name} pair {i} flow", (out.u, out.v), KITTI)
        if profile is None:
            first = outs[0]
            gpu["bm"] = (first.bm_u, first.bm_v, first.u, first.v,
                         first.segmentation.labels)
    print(f"  region buckets hit: {sorted(buckets)}")
    if len(buckets) < 2:
        rep.failures.append("flagship crossed fewer than 2 region buckets")

    # Flagship vectors point from frame 1 back to frame 0: -bg there.
    s = scene("bm")
    m = interior(s, 1, 32) & ~s.fg_mask(1)
    bm_u, bm_v = gpu["bm"][0], gpu["bm"][1]
    err = np.hypot(bm_u[m] + s.bg[0], bm_v[m] + s.bg[1])
    rep.check("default profile median |BM vector - true motion|",
              float(np.median(err)), 0.5,
              "background away from edges; half-pel search")
    phase_cli(rep, tmp)


def phase_cli(rep, tmp: Path):
    from tpuflow.cli.parser import main as cli_main
    from tpuflow.core.io import read_flow, read_pnm, write_pnm

    print("[cli] tpuflow.cli.parser.main on 3 PPM frames at 1242x375")
    s = scene("bm")
    for t in range(3):
        write_pnm(tmp / f"in_{t:04d}.ppm",
                  with_scratch(s.frame(t)).astype(np.uint8))
    pattern = str(tmp / "in_%04d.ppm")
    t0 = time.perf_counter()
    rc = cli_main(["-i", pattern, "-o", str(tmp / "bin_%04d.pgm"), "-s", "0",
                   "-e", "2", "--binary"])
    print(f"  scratch detection (--binary): rc {rc}, "
          f"{time.perf_counter() - t0:.2f} s")
    smap, _ = read_pnm(tmp / "bin_0002.pgm")
    x = s.w * 2 // 5
    col = float((smap[:, x - 1 : x + 2] > 0).any(axis=1).mean())
    rest = float((smap[:, : x - 8] > 0).mean())
    print(f"  scratch column detected on {col:.3f} of rows; "
          f"elsewhere {rest:.4f} of pixels (CPU: 0.87 and 2e-5)")
    if rc != 0 or col < 0.6 or rest > 0.01:
        rep.failures.append("cli scratch detection")
    t0 = time.perf_counter()
    rc = cli_main(["-i", pattern, "-o", str(tmp / "of_%04d.dat"), "-s", "0",
                   "-e", "2", "--opticalflow_blockmatching"])
    print(f"  block-matching flow (--opticalflow_blockmatching): rc {rc}, "
          f"{time.perf_counter() - t0:.2f} s")
    u, v = read_flow(tmp / "of_0001.dat")
    finite_shape(rep, "cli flow of_0001.dat", (u, v), KITTI)
    if rc != 0:
        rep.failures.append("cli block-matching flow")


def phase_lk(rep, gpu):
    print("[lucas-kanade] pipeline.streaming.feature_tracking_stream, "
          "1242x375, 5 frames")
    s = scene("lk")
    t0 = time.perf_counter()
    tracks = lk_run(5)
    print(f"  {len(tracks)} tracked frames in "
          f"{time.perf_counter() - t0:.2f} s (compile + run)")
    pts, prev_pts, _ = tracks[-1]
    d = pts - prev_pts
    iy = np.clip(prev_pts[:, 1].round().astype(int), 0, s.h - 1)
    ix = np.clip(prev_pts[:, 0].round().astype(int), 0, s.w - 1)
    t = len(tracks) - 1
    m = interior(s, t, 24)[iy, ix]
    u, v = s.flow(t)
    err = np.hypot(d[:, 0] - u[iy, ix], d[:, 1] - v[iy, ix])[m]
    rep.check(f"tracked points ({m.sum()} interior of {len(pts)}) median "
              "error vs true motion", float(np.median(err)), 0.1,
              "subpixel pyramidal LK on textured layers")
    gpu["lk"] = lk_run(3)[-1][:2]


def compare_cpu(rep, gpu, ref):
    print("[gpu vs cpu] the same calls on JAX's CPU backend")
    for key in ("fb_stream", "fb_large"):
        e = epe(*gpu[key], ref[f"{key}_0"], ref[f"{key}_1"])
        rep.check(f"{key} p99 |gpu - cpu|", float(np.percentile(e, 99)),
                  1e-2, "f32 reduction order; det-clamped 2x2 solves "
                  "amplify it at a few degenerate pixels")
    bm_u, bm_v, _, _, labels = gpu["bm"]
    same_seg = np.array_equal(labels, ref["bm_4"])
    agree = float(np.mean((bm_u == ref["bm_0"]) & (bm_v == ref["bm_1"])))
    print(f"  flagship segmentation identical to the CPU run: {same_seg}")
    rep.check("flagship share of pixels whose BM winner differs from CPU",
              1.0 - agree, 1e-3, "HIGHEST-precision search; near-ties "
              "may flip")
    pts, prev = gpu["lk"]
    if pts.shape == ref["lk_0"].shape:
        rep.check("LK max |points - cpu|", float(np.abs(
            pts - ref["lk_0"]).max()), 1e-2, "f32 reduction order")
    else:
        rep.failures.append("LK accepted another number of tracks on CPU")


# ---------------------------------------------------------------------------
# Multi-device phase


def phase_multi(rep, n_dev: int):
    import jax.numpy as jnp

    from tpuflow.core.config import MultipleMotionParam
    from tpuflow.dist import make_mesh
    from tpuflow.dist.farneback import farneback_sharded
    from tpuflow.dist.pyramid import optical_flow_pyramid_sharded
    from tpuflow.dist.solvers import horn_schunck_sharded_fused
    from tpuflow.solvers import (
        calc_optical_flow_farneback,
        horn_schunck_conv,
        optical_flow_pyramid_fast,
    )

    mesh = make_mesh(n_dev)
    print(f"[multi-device] mesh {dict(mesh.shape)} over "
          f"{[d.id for d in mesh.devices.flat]}")

    def placement(label, arr):
        shards = sorted({(s.device.id, s.data.shape)
                         for s in arr.addressable_shards})
        print(f"  {label} shards: {shards}")
        if len({d for d, _ in shards}) < n_dev:
            rep.failures.append(f"{label} not spread over {n_dev} devices")

    for name in ("hs_1080p", "hs_4k"):
        s = scene(name)
        p = jnp.asarray(s.frame(0), jnp.float32)
        n = jnp.asarray(s.frame(1), jnp.float32)
        u, v = rep.time(f"{name} horn_schunck_sharded_fused", lambda:
                        horn_schunck_sharded_fused(p, n, mesh, HS_WINDOW,
                                                   HS_ITERS, 1.0, fuse=5))
        placement(name, u)
        u1, v1 = rep.time(f"{name} single device (horn_schunck_conv)",
                          lambda: horn_schunck_conv(p, n, HS_WINDOW,
                                                    HS_ITERS, 1.0))
        rep.check(f"{name} max |sharded - single|",
                  float(epe(u, v, np.asarray(u1), np.asarray(v1)).max()),
                  1e-4, "same Jacobi iteration, f32 sum order")

    for key, cfg in (("fb_stream", FB_STREAM), ("fb_large", FB_MULTI)):
        s = scene(key)
        p = jnp.asarray(s.frame(0), jnp.float32)
        n = jnp.asarray(s.frame(1), jnp.float32)
        u, v = rep.time(f"{key} farneback_sharded", lambda:
                        farneback_sharded(p, n, mesh, **cfg))
        placement(key, u)
        u1, v1 = rep.time(f"{key} single device", lambda:
                          calc_optical_flow_farneback(p, n, None, **cfg))
        rep.check(f"{key} p99 |sharded - single|", float(np.percentile(
            epe(u, v, np.asarray(u1), np.asarray(v1)), 99)), 1e-2,
            "tiled == single-device up to f32 order (bitwise on CPU)")

    s = scene("ba")
    p = jnp.asarray(s.frame(0), jnp.float32)
    n = jnp.asarray(s.frame(1), jnp.float32)
    # Four levels on a crop to multiples of 16 (368 x 1232): every level
    # splits evenly over a 2 x 2 mesh with tiles wider than the fused
    # halo, so each takes the fused path and the single-device fast
    # path's stop cadence.
    param = MultipleMotionParam(level=3)
    p, n = p[: s.h // 16 * 16, : s.w // 16 * 16], n[: s.h // 16 * 16,
                                                    : s.w // 16 * 16]
    u, v = rep.time("optical_flow_pyramid_sharded", lambda:
                    optical_flow_pyramid_sharded(
                        p, n, mesh, 255.0, param, iter_scale=BA_ITER_SCALE,
                        fuse=BA_FUSE), repeats=1)
    placement("ba", u)
    u1, v1 = rep.time("optical_flow_pyramid_fast single device", lambda:
                      optical_flow_pyramid_fast(
                          p, n, 255.0, param, iter_scale=BA_ITER_SCALE,
                          fuse=BA_FUSE), repeats=1)
    rep.check("ba max |sharded - single|", float(epe(
        u, v, np.asarray(u1), np.asarray(v1)).max()), 1e-4,
        "same sweeps and stop cadence, f32 sum order")

    s = scene("bm_hd")
    t0 = time.perf_counter()
    bm_u, bm_v, fu, fv, labels = flagship_pair(s, mesh)
    print(f"  flagship mesh=make_mesh({n_dev}) 1920x1080 pair: "
          f"{time.perf_counter() - t0:.2f} s (compile + run)")
    finite_shape(rep, "flagship sharded flow", (fu, fv), HD)
    t0 = time.perf_counter()
    single = flagship_pair(s, None)
    print(f"  flagship single device: {time.perf_counter() - t0:.2f} s "
          f"(compile + run)")
    agree = float(np.mean((bm_u == single[0]) & (bm_v == single[1])))
    rep.check("flagship share of BM winners differing, mesh vs single",
              1.0 - agree, 1e-3, "same search, tiled")


# ---------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device path on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devs[0].platform!r}", file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"{args.devices} GPUs asked, {len(devs)} found",
              file=sys.stderr)
        return 2
    import tpuflow  # noqa: F401  (compile cache placement)

    print(f"[device] {nvidia_smi_line()}")
    print(f"[device] jax {jax.__version__}, {devs[0].device_kind}, "
          f"{len(devs)} device(s)", flush=True)
    rep = Report()
    gpu = {}
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        if args.devices > 1:
            phase_multi(rep, args.devices)
        else:
            child, ref_path, log = start_cpu_reference(tmp)
            try:
                phase_farneback(rep, gpu)
                phase_flagship(rep, gpu, tmp)
                phase_lk(rep, gpu)
                ref = wait_cpu_reference(child, ref_path, log)
                phase_hs(rep, ref)
                phase_black_anandan(rep, ref)
                compare_cpu(rep, gpu, ref)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
    if rep.failures:
        print(f"FAILED: {rep.failures}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
