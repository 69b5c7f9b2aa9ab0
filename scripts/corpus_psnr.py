"""Corpus-level flagship quality: compensation PSNR over bundled pairs.

The reference ships 62 KITTI-style frame pairs under
``HornSchunckOF/img/leftimage`` (``NNNNNN_10.png``/``_11.png``) and its
de-facto quality measure is eyeballing the motion-compensated frame
(OpticalFlow.cpp:420-426). This sweeps the flagship segmentation-BM
driver over the corpus and reports, per pair and aggregated:

- flagship compensation PSNR (warp prev by the flagship flow vs next),
- the no-compensation identity PSNR,
- OpenCV Farneback compensation PSNR as an external reference.

Usage (on the GPU):
  python -u scripts/corpus_psnr.py CORPUS_DIR [--limit N] [--stride K]

``CORPUS_DIR`` holds the pairs, e.g. the reference's
``HornSchunckOF/img/leftimage``, or ``img/rightimage`` (62 stereo-right
pairs — an independent held-out set the flagship's constants were never
examined against).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402



def _gray(a: np.ndarray) -> np.ndarray:
    g = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    return g.round().astype(np.float64)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0**2 / mse)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=0,
                    help="max pairs (0 = all)")
    ap.add_argument("--stride", type=int, default=1,
                    help="take every K-th pair")
    ap.add_argument("corpus", type=Path,
                    help="directory of NNNNNN_10.png / NNNNNN_11.png pairs")
    ap.add_argument("--refine_warp", action="store_true",
                    help="non-debug dt-under-BM-warp refine (the "
                         "reference zeroes MV 'for DEBUG', "
                         "OpticalFlow_BlockMatching.cpp:291-293)")
    ap.add_argument("--blend", default="",
                    help="quality stretch: comma-"
                         "separated sigmas; gaussian-smooth the "
                         "composed flow with each before compensation "
                         "(soft region-boundary blending) and report "
                         "extra columns")
    ap.add_argument("--plateau", type=float, default=0.0,
                    help="refine plateau-stop rtol (0 = reference "
                         "run-to-budget; fast profile uses 1e-3)")
    ap.add_argument("--seg_scale", type=int, default=1,
                    help="segment on the stride-N subsampled frame and "
                         "replicate labels back (fast-profile lever)")
    ap.add_argument("--iter_max", type=int, default=2048,
                    help="gradient-refine sweep budget")
    ap.add_argument("--bm_method", default="matmul",
                    choices=["matmul", "matmul_bf16", "matmul_coarse",
                             "matmul_coarse3", "matmul_half",
                             "matmul_half2", "gather"],
                    help="integer-search evaluator (matmul_coarse: "
                         "stride-2 sweep + inclusive +-1 local "
                         "refinement — ~1/4 the candidates; "
                         "matmul_half: the stride-2 grid scored on "
                         "stride-2-subsampled frames — ~1/16 the "
                         "integer-sweep FLOPs; both quality-guarded "
                         "opt-ins)")
    ap.add_argument("--profile",
                    choices=["faithful", "fast", "turbo", "quality"],
                    default=None,
                    help="named driver profile (overrides bm_method/"
                         "refine_sup — bm_flow.PROFILES: fast = coarse "
                         "search + analytic sup + 1e-3 plateau + 1024 "
                         "cap; quality = seg_scale 2; turbo = both)")
    ap.add_argument("--prewarm", action="store_true",
                    help="pipelined mode: launch the background "
                         "region-bucket ladder prewarm after the first "
                         "pair (blockmatching/prewarm.py)")
    ap.add_argument("--subpixel", type=int, default=2,
                    help="BM subpixel scale (reference default x2; "
                         "higher is a tpuflow quality extension — the "
                         "residual vs-cv2 gap is consistent with the "
                         "x2 quantization)")
    ap.add_argument("--refine_sup", choices=["reference", "analytic"],
                    default="reference",
                    help="gradient-refine step bound: the reference's "
                         "over-damped sup or the true Geman-McClure "
                         "curvature bound (bm_flow._gated_sup)")
    ap.add_argument("--mode", choices=["gradient", "affine"],
                    default="gradient",
                    help="refinement: region-gated gradient IRLS or the "
                         "per-region affine path "
                         "(--affine_blockmatching, "
                         "Affine_BlockMatching.cpp:11-77)")
    ap.add_argument("--normalize_steps", choices=["on", "off"],
                    default="on",
                    help="affine mode only: stabilized mean-gradient "
                         "step (on, the driver default) or the "
                         "reference's literal summed-gradient step "
                         "(off)")
    ap.add_argument("--pipelined", action="store_true",
                    help="run the whole corpus as ONE continuous "
                         "sequence through the async dispatch-ahead "
                         "driver (bidirectional steady state) and "
                         "report per-pair wall times — the timing mode "
                         "that matches bench.py's bm_flagship row")
    args = ap.parse_args()
    corpus_dir = args.corpus

    import jax.numpy as jnp

    from tpuflow.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
    from tpuflow.core.io import read_image
    from tpuflow.pipeline.motion_compensation import compensate
    from tpuflow.solvers.bm_flow import optical_flow_block_matching

    try:
        import cv2
    except Exception:
        cv2 = None

    stems = sorted(p.name[:-7] for p in corpus_dir.glob("*_10.png"))
    stems = stems[:: max(args.stride, 1)]
    if args.limit:
        stems = stems[: args.limit]

    if args.pipelined:
        _pipelined_sweep(stems, corpus_dir, args, read_image)
        return

    mode_val = (MODE_OUTPUT_AFFINE_BLOCKMATCHING
                if args.mode == "affine" else 0)
    rows = []
    t_total = 0.0
    for stem in stems:
        prev, _ = read_image(str(corpus_dir / f"{stem}_10.png"))
        nxt, _ = read_image(str(corpus_dir / f"{stem}_11.png"))
        gp, gn = _gray(prev), _gray(nxt)
        t0 = time.perf_counter()
        out, _ = optical_flow_block_matching(
            prev, nxt, 255.0, iter_max=args.iter_max, mode=mode_val,
            refine_warp=args.refine_warp,
            bm_method=args.bm_method,
            subpixel_scale=args.subpixel,
            affine_normalize_steps=args.normalize_steps == "on",
            refine_sup_mode=args.refine_sup,
            refine_plateau_rtol=args.plateau,
            seg_scale=args.seg_scale,
            profile=args.profile)
        t_total += time.perf_counter() - t0
        uj = jnp.asarray(out.u.astype(np.float64))
        vj = jnp.asarray(out.v.astype(np.float64))
        comp = np.asarray(compensate(jnp.asarray(gp), uj, vj))
        # Same-interpolation comparison: the cv2 row below compensates
        # BILINEARLY, so the nearest-warped flagship number carries an
        # interpolation handicap (~0.5 dB on the motion-rich crop) that
        # says nothing about the flow. flagship_bilinear_db is the
        # apples-to-apples flow-quality column; flagship_db keeps the
        # reference-faithful nearest warp for continuity.
        comp_b = np.asarray(compensate(jnp.asarray(gp), uj, vj,
                                       method="bilinear"))
        row = {
            "pair": stem,
            "flagship_db": round(_psnr(comp, gn), 2),
            "flagship_bilinear_db": round(_psnr(comp_b, gn), 2),
            "identity_db": round(_psnr(gp, gn), 2),
        }
        for sig in [float(s) for s in args.blend.split(",") if s]:
            from scipy.ndimage import gaussian_filter as _gf

            ub = jnp.asarray(_gf(np.asarray(uj), sig))
            vb = jnp.asarray(_gf(np.asarray(vj), sig))
            comp_bl = np.asarray(compensate(jnp.asarray(gp), ub, vb,
                                            method="bilinear"))
            row[f"flagship_blend{sig:g}_db"] = round(_psnr(comp_bl, gn),
                                                     2)
        if cv2 is not None:
            flow = cv2.calcOpticalFlowFarneback(
                gn.astype(np.float32), gp.astype(np.float32), None,
                0.5, 3, 15, 3, 5, 1.2, 0)
            comp_fb = np.asarray(compensate(
                jnp.asarray(gp),
                jnp.asarray(flow[..., 0].astype(np.float64)),
                jnp.asarray(flow[..., 1].astype(np.float64)),
                method="bilinear"))
            row["cv2_farneback_db"] = round(_psnr(comp_fb, gn), 2)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def agg(key):
        vals = [r[key] for r in rows if key in r]
        return {"mean": round(float(np.mean(vals)), 2),
                "median": round(float(np.median(vals)), 2)} if vals else None

    summary = {
        "corpus": str(args.corpus),
        "mode": args.mode,
        "refine_warp": args.refine_warp,
        "refine_sup": args.refine_sup,
        "plateau": args.plateau,
        "profile": args.profile,
        "seg_scale": args.seg_scale,
        "bm_method": args.bm_method,
        "subpixel": args.subpixel,
        "normalize_steps": args.normalize_steps,
        "pairs": len(rows),
        "flagship": agg("flagship_db"),
        "flagship_bilinear": agg("flagship_bilinear_db"),
        "blend": {f"sigma{s:g}": agg(f"flagship_blend{s:g}_db")
                  for s in [float(x) for x in args.blend.split(",")
                            if x]},
        "identity": agg("identity_db"),
        "cv2_farneback": agg("cv2_farneback_db"),
        "beats_identity": int(sum(
            r["flagship_db"] > r["identity_db"] for r in rows)),
        "beats_cv2": int(sum(
            r["flagship_db"] > r.get("cv2_farneback_db", 1e9)
            for r in rows)),
        "beats_cv2_bilinear": int(sum(
            r["flagship_bilinear_db"] > r.get("cv2_farneback_db", 1e9)
            for r in rows)),
        "beats_cv2_blend": {
            f"sigma{s:g}": int(sum(
                r.get(f"flagship_blend{s:g}_db", -1e9)
                > r.get("cv2_farneback_db", 1e9) for r in rows))
            for s in [float(x) for x in args.blend.split(",") if x]},
        "driver_s_per_pair": round(t_total / max(len(rows), 1), 2),
    }
    print(json.dumps({"summary": summary}), flush=True)


def _pipelined_sweep(stems, corpus_dir, args, read_image) -> None:
    """The corpus as ONE continuous frame sequence through
    optical_flow_block_matching_async — bidirectional pipelined steady
    state (how bench.py times the flagship). Reports per-pair wall
    times: mean-with-compiles, and mean/median over the tail (every
    region-count bucket has compiled by then), resolving the pipelined-
    synthetic vs per-pair-real timing gap in the record."""
    from tpuflow.solvers.bm_flow import optical_flow_block_matching_async

    frames = []
    for stem in stems:
        frames.append(read_image(str(corpus_dir / f"{stem}_10.png"))[0])
        frames.append(read_image(str(corpus_dir / f"{stem}_11.png"))[0])

    state, pending = None, None
    times = []
    warmed = False
    t_prev = time.perf_counter()
    for a, b in zip(frames[:-1], frames[1:]):
        fin, state = optical_flow_block_matching_async(
            a, b, 255.0, iter_max=args.iter_max, state=state,
            refine_warp=args.refine_warp, bm_method=args.bm_method,
            refine_sup_mode=args.refine_sup,
            refine_plateau_rtol=args.plateau,
            subpixel_scale=args.subpixel, seg_scale=args.seg_scale,
            profile=args.profile)
        if args.prewarm and not warmed:
            warmed = True
            from tpuflow.blockmatching.prewarm import prewarm_flagship

            prewarm_flagship(
                a.shape[:2], state.segmentations[0].n_regions,
                bm_method=args.bm_method, profile=args.profile,
                include_refine=not args.refine_warp,
                refine_sup_mode=args.refine_sup)
        if pending is not None:
            pending()
        pending = fin
        now = time.perf_counter()
        times.append(now - t_prev)
        t_prev = now
    pending()
    times = np.asarray(times)
    warm = min(8, len(times) // 4)
    tail = times[warm:]
    print(json.dumps({"summary": {
        "corpus": str(args.corpus),
        "pipelined": True,
        "refine_warp": args.refine_warp,
        "bm_method": args.bm_method,
        "profile": args.profile,
        "prewarm": args.prewarm,
        "pairs": int(len(times)),
        "mean_s_per_pair_with_compiles": round(float(times.mean()), 3),
        "tail_mean_s_per_pair": round(float(tail.mean()), 3),
        "tail_median_s_per_pair": round(float(np.median(tail)), 3),
        "tail_p90_s_per_pair": round(float(np.percentile(tail, 90)), 3),
    }}), flush=True)


if __name__ == "__main__":
    main()
