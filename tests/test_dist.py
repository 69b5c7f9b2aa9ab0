"""Distributed-equivalence tests (SURVEY.md §4d): the N-device shard_map
tiled solve must match the single-device solve on the 8-virtual-device CPU
mesh set up in conftest.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuflow.dist import halo_pad_2d, make_mesh, mesh_factor
from tpuflow.dist.solvers import horn_schunck_sharded, irls_level_sharded
from tpuflow.solvers import horn_schunck
from tpuflow.solvers.black_anandan import (
    LAMBDA_D,
    LAMBDA_S,
    irls_optical_flow_level,
)


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)

from jax.sharding import NamedSharding, PartitionSpec as P

rng = np.random.default_rng(3)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


class TestMesh:
    def test_factor(self):
        assert mesh_factor(8) == (2, 4)
        assert mesh_factor(4) == (2, 2)
        assert mesh_factor(7) == (1, 7)
        assert mesh_factor(16) == (4, 4)

    def test_make_mesh(self):
        mesh = make_mesh(8)
        assert mesh.devices.shape == (2, 4)
        assert mesh.axis_names == ("ty", "tx")


class TestHalo:
    def test_halo_pad_matches_global_pad(self):
        """shard_map halo_pad_2d == global zero-pad, tile for tile."""
        mesh = make_mesh(8)
        h, w, r = 16, 32, 2
        x = jnp.asarray(rng.normal(size=(h, w)))
        spec = P("ty", "tx")
        xs = jax.device_put(x, NamedSharding(mesh, spec))

        padded_tiles = jax.jit(_shard_map(
            lambda t: halo_pad_2d(t, r), mesh,
            in_specs=spec,
            out_specs=spec,
        ))(xs)
        # Padded tiles concatenate to (h + 2*2r_y_tiles...) — instead check
        # via direct per-tile comparison.
        ty, tx = mesh.devices.shape
        th, tw = h // ty, w // tx
        gp = np.pad(np.asarray(x), r)
        out = np.asarray(padded_tiles)
        # out has shape (ty*(th+2r), tx*(tw+2r)) tiled blockwise.
        for i in range(ty):
            for j in range(tx):
                tile = out[i * (th + 2 * r):(i + 1) * (th + 2 * r),
                           j * (tw + 2 * r):(j + 1) * (tw + 2 * r)]
                want = gp[i * th:i * th + th + 2 * r,
                          j * tw:j * tw + tw + 2 * r]
                np.testing.assert_array_equal(tile, want)


class TestDistributedSolvers:
    def test_horn_schunck_equivalence(self):
        mesh = make_mesh(8)
        prev = jnp.asarray(rng.uniform(0, 255, size=(32, 64)))
        nxt = jnp.asarray(rng.uniform(0, 255, size=(32, 64)))
        u1, v1 = horn_schunck(prev, nxt, window_size=5, max_iterations=10)
        u8, v8 = horn_schunck_sharded(prev, nxt, mesh, window_size=5,
                                      max_iterations=10)
        np.testing.assert_allclose(np.asarray(u8), np.asarray(u1),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(v8), np.asarray(v1),
                                   rtol=1e-10, atol=1e-12)

    def test_irls_level_equivalence(self):
        mesh = make_mesh(8)
        h, w = 16, 32
        gx = jnp.asarray(rng.normal(size=(h, w)))
        gy = jnp.asarray(rng.normal(size=(h, w)))
        it = jnp.asarray(0.1 * rng.normal(size=(h, w)))
        z = jnp.zeros((h, w))
        sd, ss = 0.4, 0.2
        u1, v1, _, _, _ = irls_optical_flow_level(
            z, z, gx, gy, it, LAMBDA_D, LAMBDA_S, sd, ss, 30, 1e-6, False)
        u8, v8 = irls_level_sharded(
            z, z, gx, gy, it, mesh, LAMBDA_D, LAMBDA_S, sd, ss, 30, 1e-6,
            False)
        np.testing.assert_allclose(np.asarray(u8), np.asarray(u1),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(v8), np.asarray(v1),
                                   rtol=1e-9, atol=1e-11)

    def test_irls_level0_cadence_equivalence(self):
        mesh = make_mesh(4)
        h, w = 16, 16
        gx = jnp.asarray(rng.normal(size=(h, w)))
        gy = jnp.asarray(rng.normal(size=(h, w)))
        it = jnp.asarray(0.1 * rng.normal(size=(h, w)))
        z = jnp.zeros((h, w))
        u1, v1, _, _, _ = irls_optical_flow_level(
            z, z, gx, gy, it, LAMBDA_D, LAMBDA_S, 0.14, 0.02, 70, 1e-6, True)
        u4, v4 = irls_level_sharded(
            z, z, gx, gy, it, mesh, LAMBDA_D, LAMBDA_S, 0.14, 0.02, 70, 1e-6,
            True)
        np.testing.assert_allclose(np.asarray(u4), np.asarray(u1),
                                   rtol=1e-9, atol=1e-11)

    def test_irls_analytic_sup_equivalence(self):
        """sup_mode="analytic" (the true Geman-McClure Lipschitz bound)
        matches between the sharded and single-device levels too."""
        mesh = make_mesh(4)
        h, w = 16, 16
        gx = jnp.asarray(rng.normal(size=(h, w)))
        gy = jnp.asarray(rng.normal(size=(h, w)))
        it = jnp.asarray(0.1 * rng.normal(size=(h, w)))
        z = jnp.zeros((h, w))
        u1, v1, _, _, _ = irls_optical_flow_level(
            z, z, gx, gy, it, LAMBDA_D, LAMBDA_S, 0.14, 0.02, 70, 1e-6,
            True, "analytic")
        u4, v4 = irls_level_sharded(
            z, z, gx, gy, it, mesh, LAMBDA_D, LAMBDA_S, 0.14, 0.02, 70,
            1e-6, True, sup_mode="analytic")
        np.testing.assert_allclose(np.asarray(u4), np.asarray(u1),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(v4), np.asarray(v1),
                                   rtol=1e-9, atol=1e-11)


class TestFusedSharded:
    def test_fused_matches_unfused(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from tpuflow.dist import make_mesh
        from tpuflow.dist.solvers import (
            horn_schunck_sharded,
            horn_schunck_sharded_fused,
        )
        from tpuflow.solvers import horn_schunck

        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        rng = np.random.default_rng(4)
        prev = jnp.asarray(rng.uniform(0, 255, (h, w)))
        nxt = jnp.asarray(np.roll(np.asarray(prev), 1, axis=1))
        u_ref, v_ref = horn_schunck(prev, nxt, 5, 12, 1.0)
        u_f, v_f = horn_schunck_sharded_fused(prev, nxt, mesh, 5, 12, 1.0,
                                              fuse=4)
        np.testing.assert_allclose(np.asarray(u_f), np.asarray(u_ref),
                                   rtol=0, atol=1e-10)
        u_s, v_s = horn_schunck_sharded(prev, nxt, mesh, 5, 12)
        np.testing.assert_allclose(np.asarray(u_f), np.asarray(u_s),
                                   rtol=0, atol=1e-10)

    def test_fused_remainder(self):
        import jax.numpy as jnp
        import numpy as np

        from tpuflow.dist import make_mesh
        from tpuflow.dist.solvers import horn_schunck_sharded_fused
        from tpuflow.solvers import horn_schunck

        mesh = make_mesh(4)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        rng = np.random.default_rng(5)
        prev = jnp.asarray(rng.uniform(0, 255, (h, w)))
        nxt = jnp.asarray(rng.uniform(0, 255, (h, w)))
        u_ref, v_ref = horn_schunck(prev, nxt, 5, 7, 1.0)
        u_f, _ = horn_schunck_sharded_fused(prev, nxt, mesh, 5, 7, 1.0,
                                            fuse=3)
        np.testing.assert_allclose(np.asarray(u_f), np.asarray(u_ref),
                                   rtol=0, atol=1e-10)


class TestDistributedPyramid:
    def test_matches_single_device(self, small_pair):
        import jax.numpy as jnp
        import numpy as np

        from tpuflow.core.config import MultipleMotionParam
        from tpuflow.dist import make_mesh
        from tpuflow.dist.pyramid import optical_flow_pyramid_sharded
        from tpuflow.solvers import optical_flow_pyramid

        prev, nxt = small_pair
        mesh = make_mesh(4)
        param = MultipleMotionParam(level=2)
        u_ref, v_ref = optical_flow_pyramid(
            jnp.asarray(prev), jnp.asarray(nxt), 255.0, param,
            iter_scale=0.02)
        u_d, v_d = optical_flow_pyramid_sharded(
            jnp.asarray(prev), jnp.asarray(nxt), mesh, 255.0, param,
            iter_scale=0.02)
        np.testing.assert_allclose(np.asarray(u_d), np.asarray(u_ref),
                                   rtol=0, atol=5e-8)
        np.testing.assert_allclose(np.asarray(v_d), np.asarray(v_ref),
                                   rtol=0, atol=5e-8)


class TestWeakScaling:
    def test_report_structure(self):
        from tpuflow.dist.scaling import weak_scaling_report

        rep = weak_scaling_report(tile_hw=(32, 32), iterations=4,
                                  fuse=2, repeats=1)
        assert rep["runs"][0]["devices"] == 1
        assert rep["runs"][0]["efficiency"] == 1.0
        assert len(rep["runs"]) >= 2  # 8 virtual devices available
        for r in rep["runs"]:
            assert r["seconds"] > 0


class TestFusedComposition:
    """The distributed production path: shard_map halo exchange feeding
    the SAME fused sweep bodies (tpuflow.ops.stencil) as the
    single-device path."""

    def test_hs_fused_matches_single_device(self):
        from tpuflow.dist import make_mesh
        from tpuflow.dist.solvers import horn_schunck_sharded_fused

        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        r = np.random.default_rng(9)
        prev = jnp.asarray(r.uniform(0, 255, (h, w)))
        nxt = jnp.asarray(np.roll(np.asarray(prev), 1, axis=1))
        u_ref, v_ref = horn_schunck(prev, nxt, 5, 11, 1.0)
        u_k, v_k = horn_schunck_sharded_fused(
            prev, nxt, mesh, 5, 11, 1.0, fuse=4)
        np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_ref),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_ref),
                                   rtol=0, atol=1e-10)

    def test_irls_fused_matches_fast_path(self):
        """irls_level_sharded_fused == irls_level_fast (same sweeps, same
        block cadence) across an 8-device mesh."""
        from tpuflow.dist import make_mesh
        from tpuflow.dist.solvers import irls_level_sharded_fused
        from tpuflow.solvers.black_anandan_fast import irls_level_fast

        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 16 * ty, 16 * tx
        r = np.random.default_rng(10)
        gx = jnp.asarray(r.normal(size=(h, w)))
        gy = jnp.asarray(r.normal(size=(h, w)))
        it = jnp.asarray(0.1 * r.normal(size=(h, w)))
        z = jnp.zeros((h, w))
        u1, v1, _, _, _ = irls_level_fast(
            z, z, gx, gy, it, 0.4, 0.2, 24, 1e-6, False, fuse=4)
        u8, v8 = irls_level_sharded_fused(
            z, z, gx, gy, it, mesh, LAMBDA_D, LAMBDA_S, 0.4, 0.2,
            24, 1e-6, False, fuse=4)
        np.testing.assert_allclose(np.asarray(u8), np.asarray(u1),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(v8), np.asarray(v1),
                                   rtol=0, atol=1e-10)

    def test_pyramid_fused_matches_fast(self, small_pair):
        """Full distributed coarse-to-fine with fused levels == the
        single-device fast path (same cadences)."""
        from tpuflow.core.config import MultipleMotionParam
        from tpuflow.dist import make_mesh
        from tpuflow.dist.pyramid import optical_flow_pyramid_sharded
        from tpuflow.solvers.black_anandan_fast import optical_flow_pyramid_fast

        prev, nxt = small_pair
        mesh = make_mesh(4)
        param = MultipleMotionParam(level=2)
        u_ref, v_ref = optical_flow_pyramid_fast(
            jnp.asarray(prev), jnp.asarray(nxt), 255.0, param,
            iter_scale=0.02, fuse=4)
        u_d, v_d = optical_flow_pyramid_sharded(
            jnp.asarray(prev), jnp.asarray(nxt), mesh, 255.0, param,
            iter_scale=0.02, fuse=4)
        np.testing.assert_allclose(np.asarray(u_d), np.asarray(u_ref),
                                   rtol=0, atol=5e-8)
        np.testing.assert_allclose(np.asarray(v_d), np.asarray(v_ref),
                                   rtol=0, atol=5e-8)


class TestFarnebackSharded:
    """Tiled single-level Farneback == single-device (SURVEY.md §2.6:
    image-domain decomposition extends to every window-local algorithm;
    reference configs FarnebackOF.cpp:24 / DenseFlow.cpp:37)."""

    def _pair(self, h, w, dtype=np.float32):
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(
            rng.uniform(0, 255, (h + 8, w + 8)), 3.0).astype(dtype)
        prev = base[:h, :w].copy()
        nxt = base[2:2 + h, 1:1 + w].copy()  # |flow| ~ (1, 2): << warp halo
        return prev, nxt

    def test_clamp_halo_matches_edge_pad(self):
        from tpuflow.dist import make_mesh
        from tpuflow.dist.farneback import halo_pad_2d_clamp

        mesh = make_mesh(8)
        h, w, r = 16, 32, 3
        x = jnp.asarray(rng.normal(size=(h, w)), jnp.float32)
        spec = P("ty", "tx")
        xs = jax.device_put(x, NamedSharding(mesh, spec))
        tiles = jax.jit(_shard_map(
            lambda t: halo_pad_2d_clamp(t, r)[None, None],
            mesh, in_specs=spec,
            out_specs=P("ty", "tx", None, None)))(xs)
        ty, tx = mesh.devices.shape
        th, tw = h // ty, w // tx
        ref = np.pad(np.asarray(x), r, mode="edge")
        tiles = np.asarray(tiles).reshape(ty, tx, th + 2 * r, tw + 2 * r)
        for i in range(ty):
            for j in range(tx):
                want = ref[i * th:i * th + th + 2 * r,
                           j * tw:j * tw + tw + 2 * r]
                np.testing.assert_array_equal(tiles[i, j], want)

    @pytest.mark.parametrize("winsize,iterations,poly_n,poly_sigma", [
        (16, 2, 5, 1.2),   # streaming-shaped config (even winsize)
        (15, 3, 5, 1.1),   # odd winsize, 3 iterations
    ])
    def test_matches_single_device(self, winsize, iterations, poly_n,
                                   poly_sigma):
        from tpuflow.dist import make_mesh
        from tpuflow.dist.farneback import farneback_sharded
        from tpuflow.solvers.farneback import calc_optical_flow_farneback

        mesh = make_mesh(8)
        prev, nxt = self._pair(64, 128)
        u1, v1 = calc_optical_flow_farneback(
            prev, nxt, None, 0.5, 1, winsize, iterations, poly_n,
            poly_sigma, 0)
        u2, v2 = farneback_sharded(
            prev, nxt, mesh, 0.5, 1, winsize, iterations, poly_n,
            poly_sigma)
        np.testing.assert_allclose(np.asarray(u2), np.asarray(u1),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(v1),
                                   atol=1e-5)

    @pytest.mark.parametrize("levels", [2, 3])
    def test_multilevel_matches_single_device(self, levels):
        """Multi-level configs (the HS-demo comparison shape,
        HornSchunckOF/main.cpp:111): coarse levels replicated, finest
        level tiled with the prolonged coarse flow as warm start —
        must match the single-device multi-level solve."""
        from tpuflow.dist import make_mesh
        from tpuflow.dist.farneback import farneback_sharded
        from tpuflow.solvers.farneback import calc_optical_flow_farneback

        mesh = make_mesh(8)
        prev, nxt = self._pair(64, 128)
        u1, v1 = calc_optical_flow_farneback(
            prev, nxt, None, 0.5, levels, 15, 3, 5, 1.2, 0)
        u2, v2 = farneback_sharded(
            prev, nxt, mesh, 0.5, levels, 15, 3, 5, 1.2)
        np.testing.assert_allclose(np.asarray(u2), np.asarray(u1),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(v1),
                                   atol=1e-5)


class TestMeanShiftSharded:
    """Tiled mean-shift filtering == single-device (the flagship BM
    path's segmentation stage, OpticalFlow_BlockMatching.cpp:122-135)."""

    def test_matches_single_device(self):
        from tpuflow.dist import make_mesh
        from tpuflow.segmentation.meanshift import (
            mean_shift_filter,
            mean_shift_filter_sharded,
        )

        mesh = make_mesh(8)
        lab = rng.uniform(0, 1, (32, 64, 3)).astype(np.float32)
        pos1, col1 = mean_shift_filter(jnp.asarray(lab), 4, 0.1, iters=4)
        pos2, col2 = mean_shift_filter_sharded(lab, mesh, 4, 0.1, iters=4)
        np.testing.assert_array_equal(np.asarray(pos2), np.asarray(pos1))
        np.testing.assert_array_equal(np.asarray(col2), np.asarray(col1))

    def test_rejects_small_tiles(self):
        from tpuflow.dist import make_mesh
        from tpuflow.segmentation.meanshift import mean_shift_filter_sharded

        lab = rng.uniform(0, 1, (16, 32, 3)).astype(np.float32)
        with pytest.raises(ValueError):
            mean_shift_filter_sharded(lab, make_mesh(8), 20, 0.1)


class TestBlockMatchingSharded:
    """Candidate-parallel distributed BM == single-device
    (OpticalFlow_BlockMatching.cpp:198-219 search split over the mesh)."""

    def test_matches_single_device(self):
        from tpuflow.blockmatching import block_matching_labels
        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm import block_matching_labels_sharded
        from tpuflow.segmentation import segment_meanshift

        mesh = make_mesh(8)
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(
            rng.uniform(0, 1, (40, 64, 3)), (2, 2, 0)).astype(np.float32)
        cur = base[2:34, 1:49]
        ref = base[:32, :48]
        seg = segment_meanshift(cur, 4, 0.12, iters=3, min_size=4)
        r1 = block_matching_labels(cur, ref, seg.labels, seg.n_regions,
                                   search_range=9, subpixel_scale=2)
        r2 = block_matching_labels_sharded(
            cur, ref, seg.labels, seg.n_regions, mesh,
            search_range=9, subpixel_scale=2)
        np.testing.assert_array_equal(r2.region_uv, r1.region_uv)
        np.testing.assert_array_equal(r2.region_cost, r1.region_cost)
        np.testing.assert_array_equal(r2.u, r1.u)

    def test_fused_bidirectional_matches_single_device(self):
        """The fused two-direction candidate-parallel search over 8
        devices == the fused single-device program, bitwise."""
        import jax.numpy as jnp

        from tpuflow.blockmatching.matcher import (
            _match_device_bidirectional,
        )
        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm import _match_device_sharded_bidirectional
        from tpuflow.segmentation import segment_meanshift

        mesh = make_mesh(8)
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(
            rng.uniform(0, 1, (40, 64, 3)), (2, 2, 0)).astype(np.float32)
        cur = base[2:34, 1:49]
        refp = base[:32, :48]
        refn = base[4:36, 2:50]
        seg = segment_meanshift(cur, 4, 0.12, iters=3, min_size=4)
        single = _match_device_bidirectional(
            jnp.asarray(cur), jnp.asarray(refp), jnp.asarray(refn),
            seg.labels, seg.n_regions, 9, 1.0, 0.5, 2, 16)
        sharded = _match_device_sharded_bidirectional(
            cur, refp, refn, seg.labels, seg.n_regions, mesh,
            9, 1.0, 0.5, 2, 16)
        for (uv_s, c_s), (uv_d, c_d) in zip(single, sharded):
            np.testing.assert_array_equal(np.asarray(uv_d),
                                          np.asarray(uv_s))
            np.testing.assert_array_equal(np.asarray(c_d),
                                          np.asarray(c_s))

    @pytest.mark.parametrize("method", ["matmul_coarse", "matmul_half"])
    def test_coarse_methods_match_single_device(self, method):
        """The coarse/half-res searches shard along the candidate axis
        too: stride-2 subgrid split over 8 devices + replicated full-res
        local refinement == the single-device program, bitwise."""
        from tpuflow.blockmatching import block_matching_labels
        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm import block_matching_labels_sharded
        from tpuflow.segmentation import segment_meanshift

        mesh = make_mesh(8)
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(
            rng.uniform(0, 1, (40, 64, 3)), (2, 2, 0)).astype(np.float32)
        cur = base[2:34, 1:49]
        ref = base[:32, :48]
        seg = segment_meanshift(cur, 4, 0.12, iters=3, min_size=4)
        r1 = block_matching_labels(cur, ref, seg.labels, seg.n_regions,
                                   search_range=9, subpixel_scale=2,
                                   method=method)
        r2 = block_matching_labels_sharded(
            cur, ref, seg.labels, seg.n_regions, mesh,
            search_range=9, subpixel_scale=2, method=method)
        np.testing.assert_array_equal(r2.region_uv, r1.region_uv)
        np.testing.assert_array_equal(r2.region_cost, r1.region_cost)

    def test_half_fused_bidirectional_matches_single_device(self):
        """matmul_half through the fused bidirectional candidate-parallel
        program == the fused single-device program, bitwise."""
        import jax.numpy as jnp

        from tpuflow.blockmatching.matcher import (
            _match_device_bidirectional,
        )
        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm import _match_device_sharded_bidirectional
        from tpuflow.segmentation import segment_meanshift

        mesh = make_mesh(8)
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(
            rng.uniform(0, 1, (40, 64, 3)), (2, 2, 0)).astype(np.float32)
        cur = base[2:34, 1:49]
        refp = base[:32, :48]
        refn = base[4:36, 2:50]
        seg = segment_meanshift(cur, 4, 0.12, iters=3, min_size=4)
        single = _match_device_bidirectional(
            jnp.asarray(cur), jnp.asarray(refp), jnp.asarray(refn),
            seg.labels, seg.n_regions, 9, 1.0, 0.5, 2, 16,
            method="matmul_half")
        sharded = _match_device_sharded_bidirectional(
            cur, refp, refn, seg.labels, seg.n_regions, mesh,
            9, 1.0, 0.5, 2, 16, method="matmul_half")
        for (uv_s, c_s), (uv_d, c_d) in zip(single, sharded):
            np.testing.assert_array_equal(np.asarray(uv_d),
                                          np.asarray(uv_s))
            np.testing.assert_array_equal(np.asarray(c_d),
                                          np.asarray(c_s))

    def test_bf16_matches_single_device(self):
        """The candidate-parallel split is precision-independent: the
        bf16 evaluator sharded over 8 devices == bf16 on one device,
        bitwise (each device rounds the same fields the same way)."""
        from tpuflow.blockmatching import block_matching_labels
        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm import block_matching_labels_sharded
        from tpuflow.segmentation import segment_meanshift

        mesh = make_mesh(8)
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(
            rng.uniform(0, 1, (40, 64, 3)), (2, 2, 0)).astype(np.float32)
        cur = base[2:34, 1:49]
        ref = base[:32, :48]
        seg = segment_meanshift(cur, 4, 0.12, iters=3, min_size=4)
        r1 = block_matching_labels(cur, ref, seg.labels, seg.n_regions,
                                   search_range=9, subpixel_scale=2,
                                   method="matmul_bf16")
        r2 = block_matching_labels_sharded(
            cur, ref, seg.labels, seg.n_regions, mesh,
            search_range=9, subpixel_scale=2, method="matmul_bf16")
        np.testing.assert_array_equal(r2.region_uv, r1.region_uv)
        np.testing.assert_array_equal(r2.region_cost, r1.region_cost)


class TestGatedRefineSharded:
    """Distributed region-gated IRLS refine (the flagship's
    OpticalFlow_GradientMethod) vs the single-chip descent."""

    def test_matches_single_device(self):
        import jax.numpy as jnp

        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm_refine import gradient_method_flow_sharded
        from tpuflow.solvers.bm_flow import gradient_method_flow

        rng = np.random.default_rng(17)
        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(rng.uniform(0, 1, (h + 4, w + 4, 3)),
                               (2, 2, 0))
        interest = jnp.asarray(base[:h, :w])
        reference = jnp.asarray(base[2 : 2 + h, 1 : 1 + w])
        # Random-ish regions spanning tile boundaries.
        labels = ((np.add.outer(np.arange(h) // 7, np.arange(w) // 9))
                  % 5).astype(np.int32)
        # iter_max below the 64-iteration energy cadence: neither path
        # early-stops, so the descents must agree step for step.
        zeros = jnp.zeros((h, w), interest.dtype)
        u_ref, v_ref = gradient_method_flow(
            reference, interest, zeros, zeros, jnp.asarray(labels),
            iter_max=32, error_min_threshold=0.0, zero_warp=True)
        u_d, v_d, trace = gradient_method_flow_sharded(
            reference, interest, labels, mesh, iter_max=32,
            error_min_threshold=0.0, fuse=8)
        np.testing.assert_allclose(np.asarray(u_d), np.asarray(u_ref),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(v_d), np.asarray(v_ref),
                                   rtol=0, atol=1e-12)

    def test_bidirectional_matches_two_serial_sharded(self):
        """gradient_method_flow_sharded_bidirectional (one program, both
        time directions) == two gradient_method_flow_sharded calls,
        bitwise — fields, traces, and the shared-operand setup."""
        import jax.numpy as jnp

        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm_refine import (
            gradient_method_flow_sharded,
            gradient_method_flow_sharded_bidirectional,
        )

        rng = np.random.default_rng(23)
        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(rng.uniform(0, 1, (h + 8, w + 8, 3)),
                               (2, 2, 0))
        ref_prev = jnp.asarray(base[:h, :w])
        interest = jnp.asarray(base[2 : 2 + h, 1 : 1 + w])
        ref_next = jnp.asarray(base[4 : 4 + h, 2 : 2 + w])
        labels = ((np.add.outer(np.arange(h) // 7, np.arange(w) // 9))
                  % 5).astype(np.int32)
        got, trace_b = gradient_method_flow_sharded_bidirectional(
            [ref_prev, ref_next], interest, labels, mesh, iter_max=128,
            error_min_threshold=0.0, fuse=8)
        for b, ref in enumerate((ref_prev, ref_next)):
            u_s, v_s, tr_s = gradient_method_flow_sharded(
                ref, interest, labels, mesh, iter_max=128,
                error_min_threshold=0.0, fuse=8)
            np.testing.assert_array_equal(np.asarray(got[b][0]),
                                          np.asarray(u_s))
            np.testing.assert_array_equal(np.asarray(got[b][1]),
                                          np.asarray(v_s))
            np.testing.assert_array_equal(np.asarray(trace_b[b]),
                                          np.asarray(tr_s))

    def test_plateau_stop_contract(self):
        """The sharded plateau stop (r5 fast profile) fires at the first
        checkpoint whose energy-improvement ratio crosses the rtol and
        freezes the trace from there (NaN tail) — verified against the
        trace's own energies. (Exact field equality with the
        single-device path is NOT expected: the fused cadence checks at
        sweeps 64, 128, ... vs the serial 1, 65, ..., the documented
        irls_gradient_method_fast deviation.)"""
        import jax.numpy as jnp

        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm_refine import gradient_method_flow_sharded

        rng = np.random.default_rng(29)
        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(rng.uniform(0, 1, (h + 4, w + 4, 3)),
                               (2, 2, 0))
        interest = jnp.asarray(base[:h, :w])
        reference = jnp.asarray(base[2 : 2 + h, 1 : 1 + w])
        labels = ((np.add.outer(np.arange(h) // 7, np.arange(w) // 9))
                  % 5).astype(np.int32)
        rtol = 0.05
        u_d, v_d, trace = gradient_method_flow_sharded(
            reference, interest, labels, mesh, iter_max=1024,
            error_min_threshold=0.0, fuse=8, sup_mode="analytic",
            plateau_rtol=rtol)
        tr = np.asarray(trace)
        assert np.isnan(tr).any(), "plateau never fired inside budget"
        valid = tr[~np.isnan(tr)]
        assert len(valid) >= 2
        # Every surviving window improved by >= rtol except the last.
        ratios = valid[1:] / valid[:-1]
        assert (ratios[:-1] < 1.0 - rtol).all()
        assert ratios[-1] >= 1.0 - rtol
        assert np.isfinite(np.asarray(u_d)).all()

    def test_energy_trace_cadence(self):
        import jax.numpy as jnp

        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm_refine import gradient_method_flow_sharded

        rng = np.random.default_rng(18)
        mesh = make_mesh(4)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        interest = jnp.asarray(rng.uniform(0, 1, (h, w, 3)))
        reference = jnp.asarray(rng.uniform(0, 1, (h, w, 3)))
        labels = (np.arange(h * w).reshape(h, w) // (h * w // 4)).astype(
            np.int32)
        u, v, trace = gradient_method_flow_sharded(
            reference, interest, labels, mesh, iter_max=128,
            error_min_threshold=0.0, fuse=8)
        trace = np.asarray(trace)
        assert trace.shape == (2,)  # checks at iterations 64 and 128
        assert np.all(np.isfinite(trace))
        # IRLS energy decreases across the cadence on this budget.
        assert trace[1] <= trace[0]


class TestFlagshipSharded:
    """optical_flow_block_matching(mesh=...) — every device stage
    multi-chip — vs the single-device driver."""

    def test_driver_matches_single_device(self):
        from tpuflow.dist import make_mesh
        from tpuflow.solvers.bm_flow import (
            BMFlowState,
            optical_flow_block_matching,
        )

        rng = np.random.default_rng(23)
        mesh = make_mesh(8)
        from scipy.ndimage import gaussian_filter

        h, w = 48, 64
        base = gaussian_filter(rng.uniform(40, 200, (h + 8, w + 8, 3)),
                               (2, 2, 0)).astype(np.float32)
        frames = [base[s : s + h, 2 * s : 2 * s + w] for s in (0, 2, 4)]

        def run(mesh_arg):
            st = BMFlowState()
            for i in range(1, 3):
                out, st = optical_flow_block_matching(
                    frames[i - 1], frames[i], mode=0, iter_max=64,
                    search_range=9, kernel_spatial=6, state=st,
                    mesh=mesh_arg)
            return out

        ref = run(None)
        dist = run(mesh)
        assert dist.bidirectional and ref.bidirectional
        np.testing.assert_array_equal(dist.segmentation.labels,
                                      ref.segmentation.labels)
        np.testing.assert_array_equal(dist.t, ref.t)
        np.testing.assert_array_equal(dist.bm_u, ref.bm_u)
        np.testing.assert_allclose(dist.u, ref.u, rtol=0, atol=1e-5)
        np.testing.assert_allclose(dist.v, ref.v, rtol=0, atol=1e-5)


class TestAffineSharded:
    def test_matches_single_device(self):
        import jax.numpy as jnp

        from tpuflow.dist import make_mesh
        from tpuflow.dist.bm_refine import affine_parametric_flow_sharded
        from tpuflow.solvers.bm_flow import affine_parametric_flow

        rng = np.random.default_rng(29)
        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        from scipy.ndimage import gaussian_filter

        base = gaussian_filter(rng.uniform(0, 1, (h + 8, w + 8, 3)),
                               (2, 2, 0))
        interest = jnp.asarray(base[:h, :w])
        reference = jnp.asarray(base[3 : 3 + h, 1 : 1 + w])
        labels = ((np.add.outer(np.arange(h) // 11, np.arange(w) // 13))
                  % 4).astype(np.int32)
        n_regions = 4
        # Constant-per-region BM warp field (what the driver feeds in).
        reg_uv = rng.integers(-3, 4, size=(n_regions, 2)).astype(np.float64)
        mv_u = reg_uv[labels][..., 0]
        mv_v = reg_uv[labels][..., 1]
        # The reference's omega=1 step is marginally stable on regions
        # this large (see affine_parametric_flow's normalize_steps note),
        # so psum-reassociation noise amplifies over long horizons:
        # compare the raw step over a short horizon and the stabilized
        # step over the full budget.
        for it_n, ns, atol in ((2, False, 1e-12), (24, True, 1e-12)):
            a_ref, u_ref, v_ref = affine_parametric_flow(
                reference, interest, mv_u, mv_v, labels, n_regions,
                iter_max=it_n, error_min_threshold=0.0,
                normalize_steps=ns)
            a_d, u_d, v_d = affine_parametric_flow_sharded(
                reference, interest, mv_u, mv_v, labels, n_regions, mesh,
                iter_max=it_n, error_min_threshold=0.0,
                normalize_steps=ns)
            np.testing.assert_allclose(np.asarray(a_d), np.asarray(a_ref),
                                       rtol=0, atol=atol)
            np.testing.assert_allclose(np.asarray(u_d), np.asarray(u_ref),
                                       rtol=0, atol=atol)
            np.testing.assert_allclose(np.asarray(v_d), np.asarray(v_ref),
                                       rtol=0, atol=atol)


    def test_affine_driver_matches_single_device(self):
        from tpuflow.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
        from tpuflow.dist import make_mesh
        from tpuflow.solvers.bm_flow import (
            BMFlowState,
            optical_flow_block_matching,
        )

        rng = np.random.default_rng(31)
        mesh = make_mesh(8)
        from scipy.ndimage import gaussian_filter

        h, w = 48, 64
        base = gaussian_filter(rng.uniform(40, 200, (h + 8, w + 8, 3)),
                               (2, 2, 0)).astype(np.float32)
        frames = [base[s : s + h, 2 * s : 2 * s + w] for s in (0, 2, 4)]

        def run(mesh_arg):
            st = BMFlowState()
            for i in range(1, 3):
                out, st = optical_flow_block_matching(
                    frames[i - 1], frames[i],
                    mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING, iter_max=4,
                    search_range=9, kernel_spatial=6, state=st,
                    mesh=mesh_arg)
            return out

        # Short horizon: the reference's omega=1 affine step amplifies
        # f32 psum-reassociation noise on large regions (see
        # test_matches_single_device's note).
        ref = run(None)
        dist = run(mesh)
        np.testing.assert_array_equal(dist.t, ref.t)
        np.testing.assert_array_equal(dist.bm_u, ref.bm_u)
        np.testing.assert_allclose(dist.u, ref.u, rtol=0, atol=5e-4)
        np.testing.assert_allclose(dist.v, ref.v, rtol=0, atol=5e-4)


class TestDynamicFused:
    def test_dynamic_matches_static(self):
        import jax.numpy as jnp

        from tpuflow.dist import make_mesh
        from tpuflow.dist.solvers import (
            horn_schunck_sharded_fused,
            horn_schunck_sharded_fused_dynamic,
        )

        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 24 * ty, 24 * tx
        r = np.random.default_rng(13)
        prev = jnp.asarray(r.uniform(0, 255, (h, w)))
        nxt = jnp.asarray(np.roll(np.asarray(prev), 1, axis=1))
        for iters in (4, 12):
            u1, v1 = horn_schunck_sharded_fused(prev, nxt, mesh, 5, iters,
                                                1.0, fuse=4)
            u2, v2 = horn_schunck_sharded_fused_dynamic(
                prev, nxt, mesh, 5, iters, 1.0, fuse=4)
            np.testing.assert_array_equal(np.asarray(u2), np.asarray(u1))
            np.testing.assert_array_equal(np.asarray(v2), np.asarray(v1))


class TestDistributedImageOps:
    """L1 image ops over the mesh vs the single-chip library
    (ImgLibrary's OMP sites, SURVEY.md §2.6)."""

    def _img(self, h, w, seed=51):
        r = np.random.default_rng(seed)
        return jnp.asarray(r.uniform(0, 255, (h, w)))

    def test_filterer_both_borders(self):
        from tpuflow.dist import make_mesh
        from tpuflow.dist.ops import filterer_sharded
        from tpuflow.ops.filters import filterer

        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        img = self._img(16 * ty, 16 * tx)
        r = np.random.default_rng(52)
        kern = jnp.asarray(r.normal(size=(5, 3)))
        for mirroring in (False, True):
            ref = filterer(img, kern, mirroring=mirroring)
            out = filterer_sharded(img, kern, mesh, mirroring=mirroring)
            np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                       rtol=0, atol=1e-10)

    def test_gaussian(self):
        from tpuflow.dist import make_mesh
        from tpuflow.dist.ops import gaussian_filter_sharded
        from tpuflow.ops.filters import gaussian_filter

        mesh = make_mesh(4)
        ty, tx = mesh.devices.shape
        img = self._img(16 * ty, 16 * tx)
        ref = gaussian_filter(img, (7, 7), 2.0)
        out = gaussian_filter_sharded(img, (7, 7), 2.0, mesh)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=0, atol=1e-10)

    def test_epsilon_filter_bitwise(self):
        from tpuflow.dist import make_mesh
        from tpuflow.dist.ops import epsilon_filter_sharded
        from tpuflow.ops.filters import epsilon_filter

        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        img = self._img(16 * ty, 16 * tx, seed=53)
        ref = epsilon_filter(img, (5, 5), 20.0)
        out = epsilon_filter_sharded(img, (5, 5), 20.0, mesh)
        # Interior is bitwise; XLA fuses the border tiles' where/add
        # chain with different contraction -> 1-ulp diffs there.
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=0, atol=1e-10)

    def test_horizontal_median_bitwise(self):
        from tpuflow.dist import make_mesh
        from tpuflow.dist.ops import horizontal_median_sharded
        from tpuflow.ops.filters import horizontal_median

        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        img = self._img(16 * ty, 16 * tx, seed=54)
        for width in (3, 4):
            ref = horizontal_median(img, width)
            out = horizontal_median_sharded(img, width, mesh)
            np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


class TestHogMatchingSharded:
    def test_matches_single_device(self):
        from scipy.ndimage import gaussian_filter as gf

        from tpuflow.dist import make_mesh
        from tpuflow.dist.ops import hog_matching_sharded
        from tpuflow.features.hog import hog_matching

        rng = np.random.default_rng(61)
        mesh = make_mesh(8)
        h, w, d = 14, 22, 6
        prv = jnp.asarray(gf(rng.uniform(0, 1, (h, w, d)), (1, 1, 0)))
        cur = jnp.asarray(np.roll(np.asarray(prv), (1, 2), axis=(0, 1))
                          + 0.01 * rng.normal(size=(h, w, d)))
        # Odd search extents exercise the sentinel padding.
        u1, v1, s1 = hog_matching(prv, cur, 9, 7)
        u8, v8, s8 = hog_matching_sharded(prv, cur, mesh, 9, 7)
        np.testing.assert_array_equal(np.asarray(u8), np.asarray(u1))
        np.testing.assert_array_equal(np.asarray(v8), np.asarray(v1))
        np.testing.assert_allclose(np.asarray(s8), np.asarray(s1),
                                   rtol=0, atol=1e-12)


class TestScratchSharded:
    def test_matches_single_device(self):
        from tpuflow.core.config import FilterParam
        from tpuflow.detection.scratch import detect_scratch
        from tpuflow.dist import make_mesh
        from tpuflow.dist.ops import detect_scratch_sharded

        rng = np.random.default_rng(71)
        mesh = make_mesh(8)
        ty, tx = mesh.devices.shape
        h, w = 16 * ty, 16 * tx
        # Integer-valued frame -> side sums exact in f64 in both
        # formulations -> identical decisions.
        img = jnp.asarray(
            rng.integers(0, 255, (h, w)).astype(np.float64))
        img = img.at[:, 37].set(255.0)  # synthetic scratch line
        ref_map, ref_filt = detect_scratch(img, 3.0, 20.0, None)
        out_map, out_filt = detect_scratch_sharded(img, mesh, 3.0, 20.0,
                                                   None)
        np.testing.assert_array_equal(np.asarray(out_map),
                                      np.asarray(ref_map))
        # Gaussian prefilter path.
        fp = FilterParam().change_filter("gaussian")
        fp.size = (5, 5)
        fp.std_deviation = 1.5
        ref_map, _ = detect_scratch(img, 3.0, 20.0, fp)
        out_map, _ = detect_scratch_sharded(img, mesh, 3.0, 20.0, fp)
        np.testing.assert_allclose(np.asarray(out_map),
                                   np.asarray(ref_map), rtol=0, atol=255)
        # Maps agree except at most a few threshold-boundary pixels
        # (the prefilter's conv reassociation): demand >= 99.9% match.
        same = np.mean(np.asarray(out_map) == np.asarray(ref_map))
        assert same > 0.999


def test_farneback_sharded_gather_fallback_matches():
    """The gather warp path (dense_warp_d=0) stays equivalent
    tiled-vs-single-device — the fallback branch the runtime-adaptive
    dense warp leaves for large motion."""
    from scipy.ndimage import gaussian_filter

    from tpuflow.dist import make_mesh
    from tpuflow.dist.farneback import farneback_sharded
    from tpuflow.solvers.farneback import calc_optical_flow_farneback

    r = np.random.default_rng(17)
    base = gaussian_filter(r.uniform(0, 255, (72, 136)), 3.0)
    prev = base[:64, :128].astype(np.float32)
    nxt = base[2:66, 1:129].astype(np.float32)
    mesh = make_mesh(8)
    u1, v1 = calc_optical_flow_farneback(
        prev, nxt, None, 0.5, 1, 15, 2, 5, 1.1, 0, dense_warp_d=0)
    u2, v2 = farneback_sharded(prev, nxt, mesh, 0.5, 1, 15, 2, 5, 1.1,
                               dense_warp_d=0)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), atol=1e-5)


def test_turbo_profile_with_mesh_runs():
    """profile="turbo" under a mesh: the seg_scale knob is single-device
    only and must be skipped (the sharded filter keeps full res); the
    search/refine knobs still apply. End-to-end driver smoke on the
    8-device mesh."""
    from scipy.ndimage import gaussian_filter

    from tpuflow.dist import make_mesh
    from tpuflow.solvers.bm_flow import optical_flow_block_matching

    mesh = make_mesh(8)
    ty, tx = mesh.devices.shape
    h, w = 16 * ty, 16 * tx
    rng_l = np.random.default_rng(44)
    base = gaussian_filter(
        rng_l.uniform(40, 200, (h + 4, w + 4, 3)), (2, 2, 0))
    f0 = base[:h, :w].astype(np.float32)
    f1 = base[2 : 2 + h, 1 : 1 + w].astype(np.float32)
    out, _ = optical_flow_block_matching(
        f0, f1, 255.0, iter_max=8, search_range=5, kernel_spatial=3,
        mesh=mesh, profile="turbo")
    assert out.u.shape == (h, w)
    assert np.isfinite(out.u).all()
