"""Segmentation, block matching and the flagship BM-flow driver.

Covers the reconstruction of the missing ImgClass surface
(Segmentation<Lab>, BlockMatching<Lab>, SURVEY.md §2.4) and the
OpticalFlow_BlockMatching composition (§3.2).
"""

import numpy as np
import pytest


def _two_region_rgb(h=40, w=60, split=30, seed=0):
    """Left region dark, right region bright, both with mild texture."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3))
    img[:, :split] = 60
    img[:, split:] = 190
    img += rng.uniform(-15, 15, (h, w, 3))
    return np.clip(img, 0, 255)


class TestMeanShift:
    def test_ms_bands_cover_disc(self):
        """The banded offset window (meanshift._ms_bands) is a sound
        superset of the Euclidean disc: every |offset| <= E_k is swept,
        the dy runs tile [-E_k, E_k] contiguously in ascending order
        (preserving the row-major accumulation order), and widths never
        exceed the square's."""
        import math

        from tpuflow.segmentation.meanshift import _ms_bands

        for E_k in (1, 2, 3, 5, 8, 20, 40):
            bands = _ms_bands(E_k)
            assert bands[0][0] == -E_k and bands[-1][1] == E_k
            prev_hi = None
            for dy_lo, dy_hi, wg in bands:
                assert dy_lo <= dy_hi and 0 <= wg <= E_k
                if prev_hi is not None:
                    assert dy_lo == prev_hi + 1
                prev_hi = dy_hi
                for dy in range(dy_lo, dy_hi + 1):
                    assert wg >= math.isqrt(E_k * E_k - dy * dy)

    def test_filter_converges_within_regions(self):
        import jax.numpy as jnp

        from tpuflow.segmentation import mean_shift_filter

        img = _two_region_rgb()
        from tpuflow.core.color import srgb_to_lab

        lab = np.asarray(srgb_to_lab(jnp.asarray(img / 255.0)))
        pos, col = mean_shift_filter(jnp.asarray(lab), kernel_spatial=5,
                                     kernel_intensity=16 / 255.0, iters=4)
        pos = np.asarray(pos)
        # Modes stay on their own side of the boundary.
        assert pos[:, :25, 0].max() < 30.5
        assert pos[:, 35:, 0].min() > 29.5

    def test_segment_two_regions(self):
        import jax.numpy as jnp

        from tpuflow.core.color import srgb_to_lab
        from tpuflow.segmentation import segment_meanshift

        rng = np.random.default_rng(0)
        img = np.zeros((40, 60, 3))
        img[:, :30] = 60
        img[:, 30:] = 190
        img = np.clip(img + rng.uniform(-8, 8, (40, 60, 3)), 0, 255)
        lab = np.asarray(srgb_to_lab(jnp.asarray(img / 255.0)))
        seg = segment_meanshift(lab, kernel_spatial=5,
                                kernel_intensity=16 / 255.0, iters=6,
                                min_size=20)
        # Essentially two regions; left and right pixels get different ids.
        assert seg.n_regions >= 2
        assert seg.labels[20, 5] != seg.labels[20, 55]
        left = seg.labels[:, :25]
        assert (left == left[0, 0]).mean() > 0.9
        regions = seg.build_regions()
        assert sum(len(r) for r in regions) == seg.labels.size


class TestBlockMatching:
    def test_grid_labels(self):
        from tpuflow.blockmatching import grid_labels

        lab = grid_labels(10, 16, 8)
        assert lab[0, 0] == 0 and lab[0, 8] == 1
        assert lab[8, 0] == 2 and lab[9, 15] == 3

    def test_unknown_method_rejected(self):
        """Typo'd evaluator names must raise, not silently dispatch to
        the f32 matmul (startswith) or the slow gather fallback."""
        import pytest

        from tpuflow.blockmatching import block_matching_labels, grid_labels

        labels = grid_labels(16, 16, 8)
        lab = np.zeros((16, 16, 3), np.float32)
        for bad in ("matmul_fp16", "gatherx", ""):
            with pytest.raises(ValueError, match="unknown block-matching"):
                block_matching_labels(lab, lab, labels, 4, search_range=3,
                                      subpixel_scale=1, method=bad)

    def test_recovers_inverse_shift(self):
        import jax.numpy as jnp

        from tpuflow.blockmatching import block_matching_labels, grid_labels
        from tpuflow.core.color import srgb_to_lab

        rng = np.random.default_rng(5)
        base = rng.uniform(0, 1, (48, 64, 3))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, (2, 2, 0))
        prev = base[4:-4, 4:-4]
        cur = base[6:-2, 5:-3]  # content moved by (-1, -2) prev->cur
        prev_lab = np.asarray(srgb_to_lab(jnp.asarray(prev)))
        cur_lab = np.asarray(srgb_to_lab(jnp.asarray(cur)))
        labels = grid_labels(40, 56, 8)
        res = block_matching_labels(cur_lab, prev_lab, labels,
                                    int(labels.max()) + 1, search_range=9,
                                    subpixel_scale=1)
        # Inverse flow: vector points back to the prev-frame position,
        # i.e. +(1, 2).
        assert abs(np.median(res.u) - 1.0) < 0.51
        assert abs(np.median(res.v) - 2.0) < 0.51

    def test_auto_margin_matches_full(self):
        """The certified reduced-margin segmentation equals the full
        margin=R run (the drift certificate guarantees every gather saw
        its whole kernel window)."""
        import jax.numpy as jnp

        from tpuflow.segmentation import segment_meanshift
        from tpuflow.segmentation.meanshift import mean_shift_filter

        rng = np.random.default_rng(12)
        from scipy.ndimage import gaussian_filter

        lab = gaussian_filter(rng.uniform(0, 1, (30, 44, 3)),
                              (2, 2, 0)).astype(np.float32)
        s_auto = segment_meanshift(lab, 6, 0.1, iters=4, min_size=4)
        s_full = segment_meanshift(lab, 6, 0.1, iters=4, min_size=4,
                                   margin=6)
        np.testing.assert_array_equal(s_auto.labels, s_full.labels)
        np.testing.assert_array_equal(s_auto.shift_spatial,
                                      s_full.shift_spatial)
        # with_drift returns the same (pos, color) plus the certificate.
        p1, c1 = mean_shift_filter(jnp.asarray(lab), 6, 0.1, iters=4)
        p2, c2, drift = mean_shift_filter(jnp.asarray(lab), 6, 0.1,
                                          iters=4, with_drift=True)
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
        assert float(drift) >= 0.0

    def test_gated_irls_sweeps_match_jnp(self):
        """The fused region-gated sweep body (tpuflow.ops.stencil, the
        tile body of tpuflow.dist.bm_refine) on the zero-padded frame ==
        the whole-frame formulation (irls_gradient_method's body), over
        several fused blocks."""
        import jax.numpy as jnp

        from tpuflow.ops.stencil import irls_sweeps_gated, nb_masks
        from tpuflow.solvers.bm_flow import irls_gradient_method

        rng = np.random.default_rng(7)
        h, w = 40, 70
        gx = jnp.asarray(rng.normal(size=(h, w)))
        gy = jnp.asarray(rng.normal(size=(h, w)))
        it = jnp.asarray(0.3 * rng.normal(size=(h, w)))
        labels = jnp.asarray(rng.integers(0, 5, (h, w)).astype(np.int32))
        args = (5.0, 1.0, 0.14, 0.02)
        iters = 32  # below the first check in both paths: pure descent
        u_ref, v_ref, _, _, _ = irls_gradient_method(
            gx, gy, it, labels, *args, iters, 0.0)
        ld, ls, sd, ss = args
        sup_x = ld * jnp.max(gx * gx) / sd**2 + 4.0 * ls / ss**2
        sup_y = ld * jnp.max(gy * gy) / sd**2 + 4.0 * ls / ss**2
        fuse = 8
        pad = lambda a, fill=0.0: jnp.pad(a, fuse, constant_values=fill)  # noqa: E731
        masks = nb_masks(-fuse, -fuse, h + 2 * fuse, w + 2 * fuse, h, w,
                         gx.dtype)
        u_f = v_f = jnp.zeros((h, w))
        for _ in range(iters // fuse):
            u_f, v_f = irls_sweeps_gated(
                pad(u_f), pad(v_f), pad(gx), pad(gy), pad(it),
                pad(labels.astype(gx.dtype), -1.0), masks, sup_x, sup_y,
                fuse, ld, ls, sd, ss)
        np.testing.assert_allclose(np.asarray(u_f), np.asarray(u_ref),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(v_f), np.asarray(v_ref),
                                   rtol=0, atol=1e-12)

    def test_batched_irls_matches_serial(self):
        """irls_gradient_method_batched (one program, both time
        directions) == two serial irls_gradient_method calls, bitwise —
        including per-element early stop: the low-energy element freezes
        at its stopping point while the other runs on, and the E(n)
        traces agree (NaN past each stopping point)."""
        import jax.numpy as jnp

        from tpuflow.solvers.bm_flow import (
            irls_gradient_method,
            irls_gradient_method_batched,
        )

        rng = np.random.default_rng(11)
        h, w = 32, 48
        gx = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
        gy = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
        # Element 0's dt is tiny -> low energy -> stops at an early
        # check against the loose threshold; element 1 runs to iter_max.
        it0 = jnp.asarray(1e-4 * rng.normal(size=(h, w)).astype(np.float32))
        it1 = jnp.asarray(0.5 * rng.normal(size=(h, w)).astype(np.float32))
        labels = jnp.asarray(rng.integers(0, 4, (h, w)).astype(np.int32))
        args = (5.0, 1.0, 0.14, 0.02)
        iters, emt = 200, 5.0
        u_b, v_b, E_b, _, tr_b = irls_gradient_method_batched(
            gx, gy, jnp.stack([it0, it1]), labels, *args, iters, emt)
        stopped_early = False
        for b, it in enumerate((it0, it1)):
            u_s, v_s, E_s, n_s, tr_s = irls_gradient_method(
                gx, gy, it, labels, *args, iters, emt)
            np.testing.assert_array_equal(np.asarray(u_b[b]),
                                          np.asarray(u_s))
            np.testing.assert_array_equal(np.asarray(v_b[b]),
                                          np.asarray(v_s))
            np.testing.assert_array_equal(np.asarray(tr_b[b]),
                                          np.asarray(tr_s))
            stopped_early |= int(n_s) < iters
        assert stopped_early, "fixture should exercise the stop masking"

    def test_bidirectional_refine_matches_serial(self):
        """gradient_method_flow_bidirectional == two serial
        gradient_method_flow(zero_warp=True) calls on Lab-like frames."""
        import jax.numpy as jnp

        from tpuflow.solvers.bm_flow import (
            gradient_method_flow,
            gradient_method_flow_bidirectional,
        )

        rng = np.random.default_rng(3)
        h, w = 24, 40
        frames = [jnp.asarray(rng.normal(size=(h, w, 3)).astype(np.float32))
                  for _ in range(3)]
        ref_prev, interest, ref_next = frames
        labels = jnp.asarray(rng.integers(0, 3, (h, w)).astype(np.int32))
        zeros = jnp.zeros((h, w), jnp.float32)
        got = gradient_method_flow_bidirectional(
            [ref_prev, ref_next], interest, labels, iter_max=96,
            error_min_threshold=1e-6)
        for (u_b, v_b), ref in zip(got, (ref_prev, ref_next)):
            u_s, v_s = gradient_method_flow(
                ref, interest, zeros, zeros, labels, iter_max=96,
                error_min_threshold=1e-6, zero_warp=True)
            np.testing.assert_array_equal(np.asarray(u_b), np.asarray(u_s))
            np.testing.assert_array_equal(np.asarray(v_b), np.asarray(v_s))

    def test_matmul_evaluator_matches_gather(self):
        """The strip-one-hot matmul evaluator and the permuted-gather +
        range-sum evaluator are the same math — identical winners and
        costs (f64; odd height exercises the strip row padding)."""
        import jax.numpy as jnp

        from tpuflow.blockmatching import block_matching_labels

        rng = np.random.default_rng(3)
        h, w = 37, 53
        cur = rng.uniform(0, 100, (h, w, 3))
        ref = np.roll(cur, (2, -3), (0, 1)) + rng.normal(0, 0.5, (h, w, 3))
        labels = rng.integers(0, 9, (h, w)).astype(np.int32)
        res = {m: block_matching_labels(jnp.asarray(cur), jnp.asarray(ref),
                                        labels, 9, 15, subpixel_scale=2,
                                        method=m)
               for m in ("matmul", "gather")}
        np.testing.assert_allclose(res["matmul"].region_uv,
                                   res["gather"].region_uv, atol=0)
        np.testing.assert_allclose(res["matmul"].region_cost,
                                   res["gather"].region_cost,
                                   rtol=1e-10, atol=1e-12)

    def test_fused_bidirectional_matches_single_direction(self):
        """The fused two-direction search program (shared cur-side
        fields/masks) is bitwise the two single-direction programs."""
        import jax.numpy as jnp

        from tpuflow.blockmatching.matcher import (
            _match_device,
            _match_device_bidirectional,
        )

        rng = np.random.default_rng(9)
        h, w = 37, 53
        cur = rng.uniform(0, 100, (h, w, 3)).astype(np.float32)
        refp = (np.roll(cur, (2, -3), (0, 1))
                + rng.normal(0, 0.5, (h, w, 3))).astype(np.float32)
        refn = (np.roll(cur, (-1, 2), (0, 1))
                + rng.normal(0, 0.5, (h, w, 3))).astype(np.float32)
        labels = rng.integers(0, 9, (h, w)).astype(np.int32)
        fused = _match_device_bidirectional(
            jnp.asarray(cur), jnp.asarray(refp), jnp.asarray(refn),
            labels, 9, 15, 1.0, 0.5, 2, 16)
        for (uv_f, c_f), ref in zip(fused, (refp, refn)):
            uv_s, c_s = _match_device(jnp.asarray(cur), jnp.asarray(ref),
                                      labels, 9, 15, 1.0, 0.5, 2, 16)
            np.testing.assert_array_equal(np.asarray(uv_f),
                                          np.asarray(uv_s))
            np.testing.assert_array_equal(np.asarray(c_f),
                                          np.asarray(c_s))

    def test_matmul_bf16_evaluator_agrees(self):
        """The bf16-input matmul evaluator finds the same winners as the
        f32 one on data with clear minima, and its costs are within the
        bf16 rounding envelope (the one-hot LHS is exact in bf16; only
        the moment fields round on matmul entry)."""
        import jax.numpy as jnp

        from tpuflow.blockmatching import block_matching_labels

        rng = np.random.default_rng(7)
        h, w = 37, 53
        cur = rng.uniform(0, 100, (h, w, 3)).astype(np.float32)
        ref = (np.roll(cur, (2, -3), (0, 1))
               + rng.normal(0, 0.5, (h, w, 3))).astype(np.float32)
        labels = rng.integers(0, 9, (h, w)).astype(np.int32)
        res = {m: block_matching_labels(jnp.asarray(cur), jnp.asarray(ref),
                                        labels, 9, 15, subpixel_scale=2,
                                        method=m)
               for m in ("matmul", "matmul_bf16")}
        np.testing.assert_array_equal(res["matmul_bf16"].region_uv,
                                      res["matmul"].region_uv)
        np.testing.assert_allclose(res["matmul_bf16"].region_cost,
                                   res["matmul"].region_cost,
                                   rtol=2e-2, atol=2e-2)

    def test_subpixel_refinement(self):
        import jax.numpy as jnp

        from tpuflow.blockmatching import block_matching_labels, grid_labels
        from scipy.ndimage import shift as ndshift

        rng = np.random.default_rng(9)
        base = rng.uniform(0, 1, (40, 48))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, 2)
        cur = ndshift(base, (0.0, -1.5), order=3, mode="nearest")
        prev_lab = np.stack([base] * 3, -1)
        cur_lab = np.stack([cur] * 3, -1)
        labels = grid_labels(40, 48, 16)
        res = block_matching_labels(jnp.asarray(cur_lab),
                                    jnp.asarray(prev_lab), labels,
                                    int(labels.max()) + 1, search_range=7,
                                    subpixel_scale=2)
        # content moved by -1.5 px in x -> inverse vector +1.5; the x2
        # subpixel grid quantizes to halves.
        assert abs(np.median(res.u) - 1.5) < 0.26

    def test_bidirectional_time_direction(self):
        import jax.numpy as jnp

        from tpuflow.blockmatching import (
            block_matching_bidirectional,
            grid_labels,
        )

        rng = np.random.default_rng(3)
        base = rng.uniform(0, 1, (44, 60))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, 2)
        prev = base[2:-6, :]
        cur = base[4:-4, :]   # moving down->content moved up? prev->cur dy=-2
        nxt = base[6:-2, :]
        mk = lambda g: jnp.asarray(np.stack([g] * 3, -1))
        labels = grid_labels(36, 60, 12)
        r_prev, r_next, t = block_matching_bidirectional(
            mk(cur), mk(prev), mk(nxt), labels, int(labels.max()) + 1,
            search_range=7, subpixel_scale=1)
        # Symmetric constant motion: prev match is -next match.
        assert abs(np.median(r_prev.v) - 2.0) < 0.51
        assert abs(np.median(r_next.v) + 2.0) < 0.51
        assert set(np.unique(t)).issubset({-1, 1})


class TestGradientMethod:
    def test_descends_toward_inverse_flow(self):
        """With the reference's default sigmas the IRLS step is ~1e-5 per
        iteration (sup is dominated by 4*lambdaS/sigmaS^2 = 8.9e3) — the
        reference budget IterMax=2048 yields a *small correction on top of
        the BM vector*, not full shift recovery. Assert descent direction
        and energy decrease instead."""
        import jax.numpy as jnp

        from tpuflow.solvers.bm_flow import (
            gradient_method_grad,
            gradient_method_dt,
            irls_gradient_method,
        )

        rng = np.random.default_rng(1)
        base = rng.uniform(0, 1, (60, 80))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, 3)
        ref = base[4:-4, 4:-4]
        interest = base[4:-4, 6:-2]  # content moved by (-2, 0)
        labels = jnp.zeros((52, 72), jnp.int32)
        z = jnp.zeros((52, 72))
        gx, gy = gradient_method_grad(jnp.asarray(interest))
        it = gradient_method_dt(jnp.asarray(ref), jnp.asarray(interest), z, z)
        u, v, E1, _, _ = irls_gradient_method(
            gx, gy, it, labels, 5.0, 1.0, 0.1414, 0.0212, 64, 1e-12)
        u2, v2, E2, _, _ = irls_gradient_method(
            gx, gy, it, labels, 5.0, 1.0, 0.1414, 0.0212, 1024, 1e-12)
        # moves in the inverse-flow (+x) direction and keeps descending
        assert float(jnp.median(u2)) > float(jnp.median(u)) > 0.0
        assert float(E2) < float(E1)

    def test_warm_start_fixed_point(self):
        """Initialized at the true inverse flow the sweep stays there
        (the data+smoothness gradient vanishes at the solution)."""
        import jax.numpy as jnp

        from tpuflow.solvers.bm_flow import (
            gradient_method_grad,
            gradient_method_dt,
            irls_gradient_method,
        )

        rng = np.random.default_rng(4)
        base = rng.uniform(0, 1, (60, 80))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, 3)
        ref = base[4:-4, 4:-4]
        interest = base[4:-4, 6:-2]  # true inverse flow (+2, 0)
        labels = jnp.zeros((52, 72), jnp.int32)
        z = jnp.zeros((52, 72))
        gx, gy = gradient_method_grad(jnp.asarray(interest))
        it = gradient_method_dt(jnp.asarray(ref), jnp.asarray(interest), z, z)
        u0 = jnp.full((52, 72), 2.0)
        u, v, _, _, _ = irls_gradient_method(
            gx, gy, it, labels, 5.0, 1.0, 0.1414, 0.0212, 512, 1e-12,
            u0, z)
        ui = np.asarray(u)[10:-10, 10:-10]
        assert abs(np.median(ui) - 2.0) < 0.2

    def test_region_gate_blocks_smoothing(self):
        """Two regions with different motion keep a sharp flow boundary."""
        import jax.numpy as jnp

        from tpuflow.solvers.bm_flow import irls_gradient_method

        h, w = 32, 64
        labels = np.zeros((h, w), np.int32)
        labels[:, w // 2 :] = 1
        gx = np.full((h, w), 0.5)
        gy = np.zeros((h, w))
        # data term wants u = -it/gx: -2 on the left, +2 on the right
        it = np.where(labels == 0, 1.0, -1.0)
        u, v, E, n, _ = irls_gradient_method(
            jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(it),
            jnp.asarray(labels), 5.0, 1.0, 0.3, 0.1, 400, 1e-12)
        u = np.asarray(u)
        left = u[:, : w // 2 - 1].mean()
        right = u[:, w // 2 + 1 :].mean()
        assert left < -1.0 and right > 1.0
        # Jump across the boundary stays sharp (no cross-region smoothing).
        jump = u[:, w // 2].mean() - u[:, w // 2 - 1].mean()
        assert jump > 1.5


class TestGatedIrlsGoldenTrace:
    def test_trace_matches_oracle_cadence(self):
        """Golden E(n) telemetry for the region-gated IRLS
        (VERDICT.md at commit 8b855a1, r3 #10): the
        trace returned by irls_gradient_method
        equals an independent NumPy oracle's energy sequence at the
        every-64-iterations cadence (E after the sweep with n == 64k,
        OpticalFlow.cpp:261-265; region-gated energy
        Error_MultipleMotion_Block, OpticalFlow_BlockMatching.cpp:
        540-590). The batched bidirectional variant inherits the pin
        via the bitwise batched==serial test above."""
        import jax.numpy as jnp

        from tests.oracles import (
            gated_irls_energy_oracle,
            gated_irls_sweep_oracle,
        )
        from tpuflow.solvers.bm_flow import irls_gradient_method

        rng = np.random.default_rng(13)
        h, w = 12, 14
        gx = rng.normal(size=(h, w))
        gy = rng.normal(size=(h, w))
        it = 0.3 * rng.normal(size=(h, w))
        labels = rng.integers(0, 3, (h, w)).astype(np.int32)
        lam_d, lam_s, sd, ss = 5.0, 1.0, 0.3, 0.1
        iters = 170  # 3 checks: n = 0, 64, 128
        u, v, E, n, trace = irls_gradient_method(
            jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(it),
            jnp.asarray(labels), lam_d, lam_s, sd, ss, iters, 1e-12)
        trace = np.asarray(trace)
        assert trace.shape == (3,)
        assert np.isfinite(trace).all()

        sup_x = lam_d * np.max(gx * gx) / sd**2 + 4.0 * lam_s / ss**2
        sup_y = lam_d * np.max(gy * gy) / sd**2 + 4.0 * lam_s / ss**2
        uo = np.zeros((h, w))
        vo = np.zeros((h, w))
        expected = []
        for k in range(iters):
            uo, vo = gated_irls_sweep_oracle(
                uo, vo, gx, gy, it, labels, lam_d, lam_s, sd, ss,
                sup_x, sup_y)
            if (k & 0x3F) == 0:
                expected.append(gated_irls_energy_oracle(
                    uo, vo, gx, gy, it, labels, lam_d, lam_s, sd, ss))
        np.testing.assert_allclose(trace, expected, rtol=1e-9)
        # The final fields match the oracle's too.
        np.testing.assert_allclose(np.asarray(u), uo, rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(np.asarray(v), vo, rtol=1e-7, atol=1e-10)


class TestAffineParametric:
    def test_normalized_steps_recover_translation(self):
        """The stabilized (mean-gradient) step recovers the per-region
        translation; the reference's omega=1 summed-gradient step only
        behaves on its small mean-shift segments."""
        import jax.numpy as jnp

        from tpuflow.solvers.bm_flow import affine_parametric_flow

        rng = np.random.default_rng(8)
        base = rng.uniform(0, 1, (60, 80))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, 3)
        ref = base[4:-4, 4:-4]
        interest = base[4:-4, 5:-3]  # content moved (-1, 0)
        mk = lambda g: jnp.asarray(np.stack([g] * 3, -1))
        labels = np.zeros((52, 72), np.int32)
        z = jnp.zeros((52, 72))
        a, u, v = affine_parametric_flow(mk(ref), mk(interest), z, z,
                                         labels, 1, iter_max=3000,
                                         normalize_steps=True)
        assert np.asarray(a).shape == (1, 6)
        ui = np.asarray(u)[10:-10, 10:-10]
        assert abs(np.median(ui) - 1.0) < 0.5

    def test_warm_start_fixed_point(self):
        """Initialized at the true translation the reference scheme stays
        near it (dE ~ 0 at the solution)."""
        import jax.numpy as jnp

        from tpuflow.solvers.bm_flow import affine_parametric_flow

        rng = np.random.default_rng(8)
        base = rng.uniform(0, 1, (60, 80))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, 3)
        ref = base[4:-4, 4:-4]
        interest = base[4:-4, 5:-3]
        mk = lambda g: jnp.asarray(np.stack([g] * 3, -1))
        labels = np.zeros((52, 72), np.int32)
        z = jnp.zeros((52, 72))
        a0 = jnp.zeros((1, 6)).at[0, 0].set(1.0)
        a, u, v = affine_parametric_flow(mk(ref), mk(interest), z, z,
                                         labels, 1, iter_max=50,
                                         normalize_steps=True, a0=a0)
        assert abs(float(np.asarray(a)[0, 0]) - 1.0) < 0.3


class TestDriver:
    def test_end_to_end_and_state(self):
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        rng = np.random.default_rng(2)
        base = rng.uniform(0, 255, (52, 72, 3))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, (2, 2, 0))
        f0 = base[2:-6, 2:-6]
        f1 = base[4:-4, 4:-4]
        f2 = base[6:-2, 6:-2]  # constant motion (-2, -2) per step

        out1, state = optical_flow_block_matching(
            f0, f1, 255.0, mode=0, iter_max=300, search_range=9,
            kernel_spatial=5)
        assert out1.u.shape == f0.shape[:2]
        assert set(np.unique(out1.t)).issubset({-1, 1})
        assert out1.quantized_rgb.dtype == np.uint8

        out2, state = optical_flow_block_matching(
            f1, f2, 255.0, mode=0, iter_max=300, search_range=9,
            kernel_spatial=5, state=state)
        # Bidirectional now: both time directions may appear, flow is the
        # inverse motion ~ +2 in the winning direction for t=-1 pixels.
        assert len(state.lab_frames) == 3
        sel = out2.t < 0
        if sel.any():
            assert abs(np.median(out2.bm_u[sel]) - 2.0) < 1.1

    def test_affine_blockmatching_mode(self):
        """The --affine_blockmatching driver path (per-region affine
        refinement instead of the gradient method)."""
        from tpuflow.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        rng = np.random.default_rng(6)
        base = rng.uniform(0, 255, (48, 64, 3))
        from scipy.ndimage import gaussian_filter as gf

        base = gf(base, (2, 2, 0))
        f0 = base[2:-4, 2:-4]
        f1 = base[4:-2, 4:-2]
        out, state = optical_flow_block_matching(
            f0, f1, 255.0, mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING,
            iter_max=60, search_range=7, kernel_spatial=5)
        assert out.u.shape == f0.shape[:2]
        assert np.isfinite(out.u).all() and np.isfinite(out.v).all()


class TestMeanShiftExactness:
    def test_matches_bruteforce_oracle(self):
        """The static-shift formulation is exact while mode drift stays
        within the margin — compare against a literal NumPy mean-shift
        (window centered on the CURRENT mode) on a small image."""
        import jax.numpy as jnp

        from tpuflow.segmentation import mean_shift_filter

        rng = np.random.default_rng(12)
        h, w, R = 18, 24, 4
        lab = rng.uniform(0, 1, (h, w, 3)) * 0.2
        lab[:, w // 2 :] += 0.5  # two color populations
        hr = 0.3

        pos, col = mean_shift_filter(jnp.asarray(lab), R, hr, iters=3)
        pos = np.asarray(pos)
        col_j = np.asarray(col)

        # Brute-force oracle.
        px = np.tile(np.arange(w, dtype=float), (h, 1))
        py = np.tile(np.arange(h, dtype=float)[:, None], (1, w))
        cl = lab.copy()
        for _ in range(3):
            npx, npy, ncl = px.copy(), py.copy(), cl.copy()
            for y in range(h):
                for x in range(w):
                    sx = sy = n = 0.0
                    sc = np.zeros(3)
                    for qy in range(h):
                        for qx in range(w):
                            dsp = (qx - px[y, x]) ** 2 + (qy - py[y, x]) ** 2
                            dcl = ((lab[qy, qx] - cl[y, x]) ** 2).sum()
                            if dsp <= R * R and dcl <= hr * hr:
                                sx += qx; sy += qy; n += 1
                                sc += lab[qy, qx]
                    if n > 0:
                        npx[y, x] = sx / n
                        npy[y, x] = sy / n
                        ncl[y, x] = sc / n
            px, py, cl = npx, npy, ncl

        np.testing.assert_allclose(pos[..., 0], px, atol=1e-4)
        np.testing.assert_allclose(pos[..., 1], py, atol=1e-4)
        np.testing.assert_allclose(col_j, cl, atol=1e-4)


class TestMeanShiftSentinel:
    def test_border_exclusion_for_any_color_range(self):
        """The color sentinel is derived from the data, so out-of-image
        points are excluded even for unnormalized inputs (values far
        outside [-1, 1]) — same result as a brute-force in-image
        mean-shift step on a constant image."""
        import jax.numpy as jnp

        from tpuflow.segmentation import mean_shift_filter

        h, w = 12, 16
        lab = np.full((h, w, 3), 57.0, np.float32)  # constant, huge range
        pos, col = mean_shift_filter(jnp.asarray(lab), 4, 2.0, iters=1)
        pos = np.asarray(pos)
        # Every mode is the centroid of the IN-IMAGE window around the
        # pixel (all colors equal): corners pull inward, center stays.
        assert np.allclose(np.asarray(col), 57.0)
        assert pos[0, 0, 0] > 0.5 and pos[0, 0, 1] > 0.5
        cx, cy = w // 2, h // 2
        exp_x = np.mean([x for x in range(cx - 4, cx + 5)
                         for y in range(cy - 4, cy + 5)
                         if (x - cx) ** 2 + (y - cy) ** 2 <= 16])
        assert abs(pos[cy, cx, 0] - exp_x) < 1e-4


class TestAsyncDriver:
    def test_async_matches_sync(self):
        """optical_flow_block_matching_async == the sync wrapper,
        bitwise, including the carried state across a 3-frame sequence
        (the async form exists so sequences dispatch frame i+1 before
        fetching frame i)."""
        from scipy.ndimage import gaussian_filter

        from tpuflow.solvers.bm_flow import (
            optical_flow_block_matching,
            optical_flow_block_matching_async,
        )

        rng = np.random.default_rng(11)
        base = gaussian_filter(rng.uniform(0, 255, (40, 68, 3)), (2, 2, 0))
        frames = [base[:32, :56], base[4:36, 2:58], base[8:40, 4:60]]
        kw = dict(iter_max=32, search_range=9, kernel_spatial=4,
                  kernel_intensity=0.12)

        s_state = None
        outs_sync = []
        for a, b in zip(frames[:-1], frames[1:]):
            out, s_state = optical_flow_block_matching(
                a, b, 255.0, state=s_state, **kw)
            outs_sync.append(out)

        a_state = None
        pending = None
        outs_async = []
        for a, b in zip(frames[:-1], frames[1:]):
            fin, a_state = optical_flow_block_matching_async(
                a, b, 255.0, state=a_state, **kw)
            if pending is not None:
                outs_async.append(pending())
            pending = fin
        outs_async.append(pending())

        for o_s, o_a in zip(outs_sync, outs_async):
            np.testing.assert_array_equal(o_a.u, o_s.u)
            np.testing.assert_array_equal(o_a.v, o_s.v)
            np.testing.assert_array_equal(o_a.t, o_s.t)
            np.testing.assert_array_equal(o_a.bm_u, o_s.bm_u)
            np.testing.assert_array_equal(o_a.quantized_rgb,
                                          o_s.quantized_rgb)


def _motion_rich_crop():
    """A 96 x 192 RGB pair of the seeded layered scene
    (tpuflow.core.synthetic) with several-pixel motion and an occluding
    foreground: (prev_rgb, next_rgb, prev_gray, next_gray)."""
    from tpuflow.core.synthetic import layered_pair

    cp, cn, _, _ = layered_pair(96, 192, seed=5, bg=(12.0, 5.0),
                                fg=(-6.0, 3.0), channels=3)

    def gray(a):
        g = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
        return g.round().astype(np.float64)

    return cp, cn, gray(cp), gray(cn)


class TestFlagshipCompensationQuality:
    def test_compensation_beats_identity_on_kitti_crop(self):
        """End-to-end quality regression: warping the previous frame by
        the flagship flow must beat NOT compensating by a clear margin
        on a motion-rich crop (several-pixel layered motion).
        Round 3 found two defects this guards against: an unclamped
        moment-form ZNCC (|zncc| in the thousands on flat regions) and
        a masked-mean MAD whose few-valid-pixel selection bias let
        border regions match garbage — together they held the flagship
        4 dB BELOW identity."""
        import jax.numpy as jnp

        from tpuflow.pipeline.motion_compensation import compensate
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        cp, cn, gp, gn = _motion_rich_crop()

        def psnr(a, b):
            return 10 * np.log10(255.0**2 / float(np.mean((a - b) ** 2)))

        out, _ = optical_flow_block_matching(
            cp, cn, 255.0, iter_max=64, search_range=41, kernel_spatial=8)
        comp = np.asarray(compensate(
            jnp.asarray(gp), jnp.asarray(out.u.astype(np.float64)),
            jnp.asarray(out.v.astype(np.float64))))
        assert psnr(comp, gn) > psnr(gp, gn) + 2.5


class TestAffineModeGroundTruth:
    def test_recovers_affine_motion(self):
        """The affine flagship mode recovers a synthetic rotation+zoom
        to ~1 px EPE. Guards the two round-3 findings: the refine must
        run in STANDARD Lab units (the reference's sigma=0.2/sqrt(2) is
        tuned against L in [0, 100]; normalized L measured EPE 1944 on
        this input), and the driver must use the stabilized
        mean-gradient step (the reference's summed-gradient omega=1
        update diverges on mean-shift-sized regions: EPE 17 with the
        scale alone)."""
        from scipy.ndimage import gaussian_filter, map_coordinates

        from tpuflow.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        rng = np.random.default_rng(5)
        H, W = 128, 192
        base = gaussian_filter(rng.uniform(0, 255, (H + 40, W + 40, 3)),
                               (3, 3, 0))
        prev = base[20:-20, 20:-20]
        th, s = 0.02, 1.01
        cy, cx = H / 2, W / 2
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        xr = cx + s * np.cos(th) * (xs - cx) - s * np.sin(th) * (ys - cy)
        yr = cy + s * np.sin(th) * (xs - cx) + s * np.cos(th) * (ys - cy)
        nxt = np.stack(
            [map_coordinates(base[..., c], [yr + 20, xr + 20], order=3)
             for c in range(3)], -1)
        out, _ = optical_flow_block_matching(
            prev, nxt, 255.0, mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING,
            iter_max=256, search_range=21, kernel_spatial=8)
        m = (slice(16, -16), slice(16, -16))
        epe = float(np.hypot(out.u[m] - (xr - xs)[m],
                             out.v[m] - (yr - ys)[m]).mean())
        assert epe < 1.6


class TestHistoryDepth:
    def test_history_max_is_four(self):
        """History_Max = 4 (OpticalFlow_BlockMatching.cpp:16-22): the
        deques keep up to four frames, popping only beyond that."""
        from tpuflow.solvers.bm_flow import HISTORY_MAX, BMFlowState

        st = BMFlowState()
        for i in range(6):
            st.push(f"lab{i}", f"rgb{i}", f"seg{i}")
        assert HISTORY_MAX == 4
        assert len(st.lab_frames) == 4
        assert st.lab_frames == ["lab5", "lab4", "lab3", "lab2"]


class TestRefineWarp:
    """The refine_warp=True lever (VERDICT.md at commit 8b855a1, r3 #4):
    the non-debug
    dt-under-BM-warp refine (OpticalFlow_BlockMatching.cpp:385-397; the
    reference zeroes MV 'for DEBUG' at :291-293 and the default keeps
    that)."""

    def _pair(self):
        """Textured two-intensity pair shifted 2 px: the BM search
        recovers a non-zero vector (smooth low-texture frames make zero
        displacement win under the zeropad convention, leaving the warp
        identical to the debug path)."""
        from scipy.ndimage import gaussian_filter as gf

        rng = np.random.default_rng(21)
        base = np.zeros((70, 104, 3))
        base[:, :52] = 80.0
        base[:, 52:] = 180.0
        base += gf(rng.uniform(-60, 60, (70, 104, 3)), (1.2, 1.2, 0))
        base = np.clip(base, 0, 255)
        return base[4:-6, 4:-8], base[4:-6, 6:-6]

    def test_bidirectional_warped_matches_serial(self):
        import jax.numpy as jnp

        from tpuflow.core.color import srgb_to_lab
        from tpuflow.solvers.bm_flow import (
            gradient_method_flow,
            gradient_method_flow_bidirectional,
        )

        f0, f1 = self._pair()
        lab0 = srgb_to_lab(jnp.asarray(f0, jnp.float32) / 255.0)
        lab1 = srgb_to_lab(jnp.asarray(f1, jnp.float32) / 255.0)
        rng = np.random.default_rng(3)
        labels = jnp.asarray(rng.integers(0, 4, f0.shape[:2]).astype(
            np.int32))
        mv0 = jnp.asarray(rng.uniform(-2, 2, (*f0.shape[:2], 2)),
                          jnp.float32)
        mv1 = jnp.asarray(rng.uniform(-2, 2, (*f0.shape[:2], 2)),
                          jnp.float32)
        got = gradient_method_flow_bidirectional(
            [lab0, lab1], lab1, labels, iter_max=96, mvs=[mv0, mv1])
        for (u_b, v_b), (r, mv) in zip(got, ((lab0, mv0), (lab1, mv1))):
            u_s, v_s = gradient_method_flow(
                r, lab1, mv[..., 0], mv[..., 1], labels, iter_max=96)
            np.testing.assert_array_equal(np.asarray(u_b),
                                          np.asarray(u_s))
            np.testing.assert_array_equal(np.asarray(v_b),
                                          np.asarray(v_s))

    def test_driver_refine_warp_runs_and_differs(self):
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        f0, f1 = self._pair()
        out0, _ = optical_flow_block_matching(
            f0, f1, 255.0, iter_max=64, search_range=9,
            kernel_spatial=4)
        out1, _ = optical_flow_block_matching(
            f0, f1, 255.0, iter_max=64, search_range=9,
            kernel_spatial=4, refine_warp=True)
        assert np.isfinite(out1.u).all()
        assert not np.array_equal(out0.u, out1.u)

    def test_refine_warp_with_mesh_matches_single_device(self):
        """refine_warp composes with mesh=: the warped dt is computed on
        the full frames and fed into the sharded refine (external_dt) —
        the composed output must match the single-device refine_warp
        run (the sharded IRLS uses the fused-block early-stop cadence,
        identical descent; tolerances cover float re-association)."""
        from tpuflow.dist import make_mesh
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        f0, f1 = self._pair()
        kw = dict(iter_max=64, search_range=9, kernel_spatial=4,
                  refine_warp=True)
        out1, _ = optical_flow_block_matching(f0, f1, 255.0, **kw)
        out8, _ = optical_flow_block_matching(f0, f1, 255.0,
                                              mesh=make_mesh(4), **kw)
        np.testing.assert_allclose(out8.u, out1.u, atol=2e-5)
        np.testing.assert_allclose(out8.v, out1.v, atol=2e-5)


class TestAffineModeCropQuality:
    def test_affine_mode_beats_identity_on_kitti_crop(self):
        """VERDICT.md at commit 8b855a1, r3 #5: corpus-level evidence for
        the per-region
        affine path (--affine_blockmatching). The full-corpus sweep
        (scripts/corpus_psnr.py --mode affine: mean 21.39 dB vs
        identity 16.91, beats identity 61/61) is pinned here at crop
        scale: the affine refinement must beat no-compensation by a
        clear margin on a motion-rich crop."""
        import jax.numpy as jnp

        from tpuflow.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
        from tpuflow.pipeline.motion_compensation import compensate
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        cp, cn, gp, gn = _motion_rich_crop()

        def psnr(a, b):
            return 10 * np.log10(255.0**2 / float(np.mean((a - b) ** 2)))

        out, _ = optical_flow_block_matching(
            cp, cn, 255.0, iter_max=64, search_range=41, kernel_spatial=8,
            mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING)
        comp = np.asarray(compensate(
            jnp.asarray(gp), jnp.asarray(out.u.astype(np.float64)),
            jnp.asarray(out.v.astype(np.float64))))
        assert psnr(comp, gn) > psnr(gp, gn) + 2.5


def test_region_bucket_ladder():
    """Buckets are 128 * (2^k or 3*2^k): monotone, >= n, consecutive
    ratio <= 1.5 (bounded padding), multiples of 128. Results are
    bucket-independent (padded regions are empty +inf ranges), so the
    ladder only trades recompiles vs padding."""
    from tpuflow.blockmatching.matcher import region_bucket

    vals = sorted({region_bucket(n) for n in range(1, 6000)})
    for n in range(1, 6000, 13):
        b = region_bucket(n)
        assert b >= n and b % 128 == 0
    # ratio <= 1.5 from 256 up (the 128->256 step is 2x — tiny counts
    # compile fast and real KITTI frames have hundreds of regions)
    big = [v for v in vals if v >= 256]
    assert all(y / x <= 1.51 for x, y in zip(big, big[1:]))
    assert region_bucket(1) == 128
    assert region_bucket(300) == 384
    assert region_bucket(385) == 512
    assert region_bucket(1200) == 1536


class TestCoarseSearch:
    """bm_method="matmul_coarse" (r4, opt-in): stride-2 integer sweep +
    inclusive +-1 local refinement — ~1/4 the integer candidates; not
    bitwise with the exhaustive search (corpus guard in
    BASELINE.md at commit 8b855a1)."""

    def test_recovers_odd_shift(self):
        """A shift with ODD components lies off the coarse grid; the
        radius-1 local refinement must recover it exactly."""
        import jax.numpy as jnp

        from scipy.ndimage import gaussian_filter as gf

        from tpuflow.blockmatching import (
            block_matching_labels,
            grid_labels,
        )
        from tpuflow.core.color import srgb_to_lab

        rng = np.random.default_rng(31)
        base = gf(rng.uniform(0, 1, (56, 72, 3)), (1.5, 1.5, 0))
        prev = base[6:-6, 6:-6]
        cur = base[9:-3, 7:-5]  # content moved by (-3, -1): odd shift
        prev_lab = np.asarray(srgb_to_lab(jnp.asarray(prev)))
        cur_lab = np.asarray(srgb_to_lab(jnp.asarray(cur)))
        labels = grid_labels(44, 60, 12)
        res = block_matching_labels(
            cur_lab, prev_lab, labels, int(labels.max()) + 1,
            search_range=11, subpixel_scale=2, method="matmul_coarse")
        assert abs(np.median(res.u) - 1.0) < 0.51
        assert abs(np.median(res.v) - 3.0) < 0.51

    def test_close_to_exhaustive(self):
        """On textured frames the coarse method's per-region winners
        land within 1 px of the exhaustive search for the vast majority
        of regions."""
        import jax.numpy as jnp

        from scipy.ndimage import gaussian_filter as gf

        from tpuflow.blockmatching import (
            block_matching_labels,
            grid_labels,
        )
        from tpuflow.core.color import srgb_to_lab

        rng = np.random.default_rng(32)
        base = gf(rng.uniform(0, 1, (64, 96, 3)), (1.2, 1.2, 0))
        prev = base[4:-4, 4:-4]
        cur = base[6:-2, 5:-3]
        prev_lab = np.asarray(srgb_to_lab(jnp.asarray(prev)))
        cur_lab = np.asarray(srgb_to_lab(jnp.asarray(cur)))
        labels = grid_labels(56, 88, 8)
        n = int(labels.max()) + 1
        full = block_matching_labels(cur_lab, prev_lab, labels, n,
                                     search_range=15, subpixel_scale=2)
        coarse = block_matching_labels(cur_lab, prev_lab, labels, n,
                                       search_range=15, subpixel_scale=2,
                                       method="matmul_coarse")
        d = np.abs(coarse.region_uv - full.region_uv).max(axis=1)
        assert (d <= 1.0).mean() > 0.9

    def test_driver_accepts_coarse(self):
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        rng = np.random.default_rng(33)
        from scipy.ndimage import gaussian_filter as gf

        base = np.clip(gf(rng.uniform(30, 220, (70, 104, 3)),
                          (1.5, 1.5, 0)), 0, 255)
        f0 = base[4:-6, 4:-8]
        f1 = base[6:-4, 5:-7]
        out, _ = optical_flow_block_matching(
            f0, f1, 255.0, iter_max=32, search_range=9, kernel_spatial=4,
            bm_method="matmul_coarse")
        assert np.isfinite(out.u).all()


class TestHalfResSearch:
    """bm_method="matmul_half" (r5, the fast profile's search): the
    stride-2 candidate grid scored on stride-2-subsampled frames (~1/16
    the integer-sweep FLOPs of the exhaustive search), then the shared
    full-res ±1 sorted-tap refinement. Not bitwise with the exhaustive
    search (corpus guard in
    BASELINE.md at commit 8b855a1, round 5)."""

    def test_recovers_odd_shift(self):
        """A shift with ODD components lies off the even grid; the
        full-res radius-1 refinement must recover it exactly."""
        import jax.numpy as jnp

        from scipy.ndimage import gaussian_filter as gf

        from tpuflow.blockmatching import (
            block_matching_labels,
            grid_labels,
        )
        from tpuflow.core.color import srgb_to_lab

        rng = np.random.default_rng(31)
        base = gf(rng.uniform(0, 1, (56, 72, 3)), (1.5, 1.5, 0))
        prev = base[6:-6, 6:-6]
        cur = base[9:-3, 7:-5]  # content moved by (-3, -1): odd shift
        prev_lab = np.asarray(srgb_to_lab(jnp.asarray(prev)))
        cur_lab = np.asarray(srgb_to_lab(jnp.asarray(cur)))
        labels = grid_labels(44, 60, 12)
        res = block_matching_labels(
            cur_lab, prev_lab, labels, int(labels.max()) + 1,
            search_range=11, subpixel_scale=2, method="matmul_half")
        assert abs(np.median(res.u) - 1.0) < 0.51
        assert abs(np.median(res.v) - 3.0) < 0.51

    def test_close_to_exhaustive(self):
        """Per-region winners land within 1 px of the exhaustive search
        for the vast majority of regions despite the quarter-resolution
        scoring pass."""
        import jax.numpy as jnp

        from scipy.ndimage import gaussian_filter as gf

        from tpuflow.blockmatching import (
            block_matching_labels,
            grid_labels,
        )
        from tpuflow.core.color import srgb_to_lab

        rng = np.random.default_rng(32)
        base = gf(rng.uniform(0, 1, (64, 96, 3)), (1.2, 1.2, 0))
        prev = base[4:-4, 4:-4]
        cur = base[6:-2, 5:-3]
        prev_lab = np.asarray(srgb_to_lab(jnp.asarray(prev)))
        cur_lab = np.asarray(srgb_to_lab(jnp.asarray(cur)))
        labels = grid_labels(56, 88, 8)
        n = int(labels.max()) + 1
        full = block_matching_labels(cur_lab, prev_lab, labels, n,
                                     search_range=15, subpixel_scale=2)
        half = block_matching_labels(cur_lab, prev_lab, labels, n,
                                     search_range=15, subpixel_scale=2,
                                     method="matmul_half")
        d = np.abs(half.region_uv - full.region_uv).max(axis=1)
        assert (d <= 1.0).mean() > 0.9

    def test_half_invisible_region_reseeds_at_zero(self):
        """A region whose every pixel sits at odd coordinates has NO
        sample on the half-res grid: every coarse cost is +inf, and the
        inf-guard must re-seed its refinement at zero displacement
        instead of the grid corner (-R, -R)."""
        import jax.numpy as jnp

        from tpuflow.blockmatching import block_matching_labels

        rng = np.random.default_rng(34)
        h, w = 32, 48
        frame = rng.uniform(0.2, 0.8, (h, w, 3)).astype(np.float32)
        labels = np.zeros((h, w), np.int32)
        labels[5, 7] = 1  # single pixel, both coordinates odd
        res = block_matching_labels(
            jnp.asarray(frame), jnp.asarray(frame), labels, 2,
            search_range=9, subpixel_scale=2, method="matmul_half")
        assert np.isfinite(res.region_cost).all()
        # identical frames: the refinement around the zero re-seed finds
        # the exact match at displacement 0
        np.testing.assert_allclose(res.region_uv[1], [0.0, 0.0])

    def test_driver_fast_profile(self):
        """profile="fast" = coarse search + analytic sup + plateau stop
        (bm_flow.PROFILES); runs end-to-end bidirectional and stays
        finite."""
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        rng = np.random.default_rng(35)
        from scipy.ndimage import gaussian_filter as gf

        base = np.clip(gf(rng.uniform(30, 220, (72, 104, 3)),
                          (1.5, 1.5, 0)), 0, 255)
        f0 = base[4:-6, 4:-8]
        f1 = base[6:-4, 5:-7]
        f2 = base[8:-2, 6:-6]
        out, st = optical_flow_block_matching(
            f0, f1, 255.0, iter_max=128, search_range=9, kernel_spatial=4,
            profile="fast")
        assert np.isfinite(out.u).all()
        out2, _ = optical_flow_block_matching(
            f1, f2, 255.0, iter_max=128, search_range=9, kernel_spatial=4,
            profile="fast", state=st)
        assert out2.bidirectional
        assert np.isfinite(out2.u).all() and np.isfinite(out2.v).all()

    def test_unknown_profile_raises(self):
        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        f = np.zeros((16, 16, 3), np.float32)
        with np.testing.assert_raises(ValueError):
            optical_flow_block_matching(f, f, 255.0, profile="warp9")


def test_plateau_stop_early():
    """plateau_rtol > 0 stops the gradient IRLS once a 64-iteration
    check window improves < rtol relative: fewer sweeps, energy within
    rtol-per-window of the full run, and the default (0.0) keeps the
    reference's run-to-budget behavior."""
    import jax.numpy as jnp

    from scipy.ndimage import gaussian_filter as gf

    from tpuflow.solvers.bm_flow import irls_gradient_method

    rng = np.random.default_rng(7)
    h, w = 48, 64
    gx = jnp.asarray(gf(rng.normal(0, 1, (h, w)), 1.5).astype(np.float32))
    gy = jnp.asarray(gf(rng.normal(0, 1, (h, w)), 1.5).astype(np.float32))
    it = jnp.asarray(gf(rng.normal(0, 1, (h, w)), 1.5).astype(np.float32))
    labels = jnp.asarray((np.arange(h)[:, None] // 16 * 4
                          + np.arange(w)[None, :] // 16).astype(np.int32))
    args = (gx, gy, it, labels, 5.0, 1.0, float(0.2 / np.sqrt(2)),
            float(0.03 / np.sqrt(2)), 2048, 1e-6)
    full = irls_gradient_method(*args, sup_mode="analytic")
    plat = irls_gradient_method(*args, sup_mode="analytic",
                                plateau_rtol=1e-3)
    assert int(plat[3]) < int(full[3])
    assert float(plat[2]) <= float(full[2]) * (1.0 + 5e-3)


def test_gated_analytic_sup_descends_faster():
    """sup_mode="analytic" (the true Geman-McClure curvature bound) is
    still monotone in energy at checkpoints and reaches a LOWER energy
    than the reference's over-damped step within the same budget."""
    import jax.numpy as jnp

    from tpuflow.solvers.bm_flow import irls_gradient_method

    rng = np.random.default_rng(17)
    h, w = 24, 32
    gx = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
    gy = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))
    it = jnp.asarray(0.4 * rng.normal(size=(h, w)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, 3, (h, w)).astype(np.int32))
    args = (5.0, 1.0, 0.1414, 0.0212)
    _, _, e_ref, _, tr_ref = irls_gradient_method(
        gx, gy, it, labels, *args, 256, 1e-12)
    _, _, e_an, _, tr_an = irls_gradient_method(
        gx, gy, it, labels, *args, 256, 1e-12, sup_mode="analytic")
    tr = np.asarray(tr_an)
    tr = tr[np.isfinite(tr)]
    assert (np.diff(tr) <= 1e-6).all()  # monotone at the check cadence
    assert float(e_an) < float(e_ref)   # faster descent, same budget


class TestSegScale:
    """seg_scale (r5 fast-profile lever): segmentation on the stride-N
    subsampled frame, labels nearest-replicated back."""

    def test_upsample_shapes_and_blockiness(self):
        from tpuflow.segmentation import segment_meanshift

        rng = np.random.default_rng(36)
        lab = rng.uniform(0, 1, (41, 63, 3)).astype(np.float32)
        s = segment_meanshift(lab, 8, 0.3, scale=2)
        assert s.labels.shape == (41, 63)
        assert s.shift_spatial.shape == (41, 63, 2)
        # Labels constant over each 2x2 block (nearest replication).
        assert (s.labels[0:40:2] == s.labels[1:41:2]).all()
        assert (s.labels[:, 0:62:2] == s.labels[:, 1:63:2]).all()

    def test_driver_seg_scale_runs_bidirectional(self):
        from scipy.ndimage import gaussian_filter as gf

        from tpuflow.solvers.bm_flow import optical_flow_block_matching

        rng = np.random.default_rng(35)
        base = np.clip(gf(rng.uniform(30, 220, (72, 104, 3)),
                          (1.5, 1.5, 0)), 0, 255)
        f0 = base[4:-6, 4:-8]
        f1 = base[6:-4, 5:-7]
        f2 = base[8:-2, 6:-6]
        out, st = optical_flow_block_matching(
            f0, f1, 255.0, iter_max=64, search_range=9, kernel_spatial=6,
            seg_scale=2)
        out2, _ = optical_flow_block_matching(
            f1, f2, 255.0, iter_max=64, search_range=9, kernel_spatial=6,
            seg_scale=2, state=st)
        assert out2.bidirectional
        assert np.isfinite(out2.u).all()
        assert out2.segmentation.labels.shape == f0.shape[:2]

    def test_mesh_rejects_scale(self):
        from tpuflow.segmentation import segment_meanshift_async

        lab = np.zeros((16, 16, 3), np.float32)
        with np.testing.assert_raises(ValueError):
            segment_meanshift_async(lab, 4, 0.1, mesh=object(), scale=2)


def test_quality_and_turbo_profiles_run():
    """profile="quality" (half-res segmentation, exhaustive search) and
    profile="turbo" (plus coarse search + plateau refine) run end-to-end
    bidirectional and stay finite."""
    from scipy.ndimage import gaussian_filter as gf

    from tpuflow.solvers.bm_flow import optical_flow_block_matching

    rng = np.random.default_rng(41)
    base = np.clip(gf(rng.uniform(30, 220, (72, 104, 3)),
                      (1.5, 1.5, 0)), 0, 255)
    f0 = base[4:-6, 4:-8]
    f1 = base[6:-4, 5:-7]
    f2 = base[8:-2, 6:-6]
    for profile in ("quality", "turbo"):
        out, st = optical_flow_block_matching(
            f0, f1, 255.0, iter_max=64, search_range=9, kernel_spatial=6,
            profile=profile)
        out2, _ = optical_flow_block_matching(
            f1, f2, 255.0, iter_max=64, search_range=9, kernel_spatial=6,
            profile=profile, state=st)
        assert out2.bidirectional and np.isfinite(out2.u).all()
        assert out2.segmentation.labels.shape == f0.shape[:2]
