"""Fused stencil sweep paths and the HS CUDA kernel's host side.

The fused sweep blocks (tpuflow.ops.stencil, and chip_smoke.hs_fused,
the plain baseline the kernel is timed against) must equal the
one-op-per-sweep solvers and the float64 NumPy oracles (tests/oracles.py)
on the CPU. The CUDA kernel runs only on the card (chip_smoke.py checks
it there against the f64 oracle); here its launch sequence (modelled in
jnp by _tile_reference), its compiled constants, build, dispatch and
batching are checked.
"""

import re

import numpy as np
import pytest

from tests.oracles import horn_schunck_oracle, irls_sweep_oracle
from tpuflow.kernels import hs_cuda


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(11)
    h, w = 45, 70  # deliberately not tile-aligned
    gx = rng.normal(size=(h, w))
    gy = rng.normal(size=(h, w))
    gt = 0.3 * rng.normal(size=(h, w))
    return gx, gy, gt


class TestHornSchunckFused:
    def _run(self, small_pair, iters, fuse):
        import jax.numpy as jnp

        from chip_smoke import hs_fused
        from tpuflow.solvers import horn_schunck

        prev, nxt = small_pair
        p = jnp.asarray(prev)
        n = jnp.asarray(nxt)
        u_ref, v_ref = horn_schunck(p, n, 5, iters, 1.0)
        u, v = hs_fused(p, n, 5, iters, 1.0, fuse=fuse)
        return np.asarray(u), np.asarray(v), np.asarray(u_ref), np.asarray(v_ref)

    def test_single_iteration(self, small_pair):
        u, v, u_ref, v_ref = self._run(small_pair, 1, 1)
        np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-12)

    def test_fused_iterations(self, small_pair):
        u, v, u_ref, v_ref = self._run(small_pair, 6, 3)
        np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-10)
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-10)

    def test_remainder_iterations(self, small_pair):
        """iters not divisible by fuse exercises the tail block."""
        u, v, u_ref, v_ref = self._run(small_pair, 7, 3)
        np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-10)
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-10)

    def test_matches_f64_oracle(self, small_pair):
        import jax.numpy as jnp

        from chip_smoke import hs_fused

        prev, nxt = small_pair
        u, v = hs_fused(jnp.asarray(prev), jnp.asarray(nxt), 5, 20, 1.0,
                        fuse=5)
        uo, vo = horn_schunck_oracle(prev, nxt, 5, 20, 1.0)
        np.testing.assert_allclose(np.asarray(u), uo, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(v), vo, rtol=1e-9, atol=1e-9)


class TestIrlsSweep:
    def test_matches_jnp_sweeps(self, fields):
        import jax.numpy as jnp

        from tpuflow.ops.stencil import irls_sweep_fused
        from tpuflow.solvers import irls_grad, irls_sup

        gx, gy, gt = (jnp.asarray(a) for a in fields)
        ld, ls, sd, ss = 5.0, 1.0, 0.4, 0.2
        sup_x, sup_y = irls_sup(gx, gy, ld, ls, sd, ss)
        u = jnp.zeros_like(gx)
        v = jnp.zeros_like(gx)
        n_iters = 5
        u_ref, v_ref = u, v
        for _ in range(n_iters):
            dx, dy = irls_grad(u_ref, v_ref, gx, gy, gt, ld, ls, sd, ss)
            u_ref = u_ref - dx / sup_x
            v_ref = v_ref - dy / sup_y
        u_k, v_k = irls_sweep_fused(
            u, v, gx, gy, gt, sup_x, sup_y, n_iters,
            lambda_d=ld, lambda_s=ls, sigma_d=sd, sigma_s=ss, fuse=2)
        np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)
        np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_ref),
                                   rtol=0, atol=1e-11)

    def test_tile_decomposition_invariance(self, fields):
        """Different fusings give the same answer, and the f64 oracle's."""
        import jax.numpy as jnp

        from tpuflow.ops.stencil import irls_sweep_fused
        from tpuflow.solvers import irls_sup

        gx, gy, gt = (jnp.asarray(a) for a in fields)
        sup_x, sup_y = irls_sup(gx, gy, 5.0, 1.0, 0.4, 0.2)
        u = jnp.zeros_like(gx)
        v = jnp.zeros_like(gx)
        args = dict(lambda_d=5.0, lambda_s=1.0, sigma_d=0.4, sigma_s=0.2)
        u1, v1 = irls_sweep_fused(u, v, gx, gy, gt, sup_x, sup_y, 4,
                                  fuse=4, **args)
        u2, v2 = irls_sweep_fused(u, v, gx, gy, gt, sup_x, sup_y, 4,
                                  fuse=1, **args)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u2),
                                   rtol=0, atol=1e-11)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2),
                                   rtol=0, atol=1e-11)
        uo = np.zeros(gx.shape)
        vo = np.zeros(gx.shape)
        for _ in range(4):
            uo, vo = irls_sweep_oracle(uo, vo, *fields, 5.0, 1.0, 0.4, 0.2,
                                       float(sup_x), float(sup_y))
        np.testing.assert_allclose(np.asarray(u1), uo, rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(v1), vo, rtol=0, atol=1e-10)


class TestBlackAnandanFast:
    def test_matches_equivalence_path(self, small_pair):
        """Fixed small iteration budget, no early stop triggers: the
        fused-block pyramid must match the one-sweep pyramid."""
        import jax.numpy as jnp

        from tpuflow.core.config import MultipleMotionParam
        from tpuflow.solvers import optical_flow_pyramid
        from tpuflow.solvers.black_anandan_fast import (
            optical_flow_pyramid_fast,
        )

        prev, nxt = small_pair
        param = MultipleMotionParam(level=2, error_min_threshold=0.0)
        u_ref, v_ref = optical_flow_pyramid(
            jnp.asarray(prev), jnp.asarray(nxt), 255.0, param,
            iter_max=8, iter_scale=1.0)
        u_f, v_f = optical_flow_pyramid_fast(
            jnp.asarray(prev), jnp.asarray(nxt), 255.0, param,
            iter_max=8, iter_scale=1.0, fuse=4)
        np.testing.assert_allclose(np.asarray(u_f), np.asarray(u_ref),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(v_f), np.asarray(v_ref),
                                   rtol=0, atol=1e-10)


def _valid_sep_oracle(padded, ky, kx):
    """Separable VALID correlation in f64 NumPy: two 1-D passes."""
    hp, wp = padded.shape
    rows = sum(ky[i] * padded[i : hp - len(ky) + 1 + i]
               for i in range(len(ky)))
    return sum(kx[j] * rows[:, j : wp - len(kx) + 1 + j]
               for j in range(len(kx)))


class TestSepConv:
    @pytest.mark.parametrize("taps", [(5, 5), (17, 17), (48, 48), (3, 21)])
    def test_matches_numpy_valid(self, taps):
        """The outer-product conv that sep_conv2d runs == two 1-D
        passes in f64."""
        import jax.numpy as jnp

        from tpuflow.ops.filters import _conv2d_valid

        nky, nkx = taps
        rng = np.random.default_rng(0)
        padded = rng.normal(size=(70 + nky - 1, 150 + nkx - 1))
        ky = rng.normal(size=nky)
        kx = rng.normal(size=nkx)
        out = _conv2d_valid(jnp.asarray(padded),
                            jnp.asarray(ky[:, None] * kx[None, :]))
        np.testing.assert_allclose(np.asarray(out),
                                   _valid_sep_oracle(padded, ky, kx),
                                   rtol=1e-12, atol=1e-10)

    @pytest.mark.parametrize("n", [8, 21, 48])
    def test_uniform_taps_box_blur(self, n):
        """Farneback's winsize box aggregation (replicate borders, the
        even-size anchor crop) == a NumPy box mean."""
        import jax.numpy as jnp

        from tpuflow.solvers.farneback import _box_blur

        rng = np.random.default_rng(1)
        h, w = 60, 140
        M = rng.normal(size=(5, h, w))
        out = np.asarray(_box_blur(jnp.asarray(M), n))
        r = n // 2
        for c in range(5):
            p = np.pad(M[c], r, mode="edge")
            taps = np.full(n, 1.0 / n)
            want = _valid_sep_oracle(p, taps, taps)[:h, :w]
            np.testing.assert_allclose(out[c], want, rtol=1e-12, atol=1e-12)


class TestTileSweeps:
    def test_hs_tile_sweeps_interior(self):
        """The shard_map tile body == the jnp solver on a full-frame
        'tile' at origin (0, 0)."""
        import jax.numpy as jnp

        from tpuflow.ops.stencil import hs_sweeps, inside_mask
        from tpuflow.solvers import horn_schunck
        from tpuflow.solvers.horn_schunck import hs_gradients

        r = np.random.default_rng(13)
        h, w = 24, 40
        fuse = 3
        prev = jnp.asarray(r.uniform(0, 255, (h, w)))
        nxt = jnp.asarray(r.uniform(0, 255, (h, w)))
        u_ref, v_ref = horn_schunck(prev, nxt, 5, fuse, 1.0)
        gx, gy, gt = hs_gradients(prev, nxt)
        inv = 1.0 / (1.0 + gx * gx + gy * gy)
        need = fuse * 2
        pad = lambda a: jnp.pad(a, need)  # noqa: E731
        mask = inside_mask(-need, -need, h + 2 * need, w + 2 * need, h, w,
                           gx.dtype)
        z = pad(jnp.zeros((h, w)))
        u, v = hs_sweeps(z, z, pad(gx), pad(gy), pad(gt), pad(inv), mask,
                         5, fuse)
        np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref),
                                   rtol=0, atol=1e-10)


class TestFbBlurSolve:
    @pytest.mark.parametrize("h,w,K", [(64, 96, 15), (57, 83, 48)])
    def test_matches_numpy_box_solve(self, h, w, K):
        """_blur_solve (box aggregation + 2x2 solve) == NumPy f64 on a
        well-conditioned normal-equation field."""
        import jax.numpy as jnp

        from tpuflow.solvers.farneback import _blur_solve

        r = np.random.default_rng(0)
        a11 = r.normal(size=(h, w))
        a12 = 0.2 * r.normal(size=(h, w))
        a22 = r.normal(size=(h, w))
        db1 = r.normal(size=(h, w))
        db2 = r.normal(size=(h, w))
        M = np.stack([a11 * a11 + a12 * a12, a12 * (a11 + a22),
                      a12 * a12 + a22 * a22,
                      a11 * db1 + a12 * db2, a12 * db1 + a22 * db2])
        u, v = _blur_solve(jnp.asarray(M), K, False)
        taps = np.full(K, 1.0 / K)
        m11, m12, m22, h1, h2 = (
            _valid_sep_oracle(np.pad(c, K // 2, mode="edge"), taps,
                              taps)[:h, :w] for c in M)
        det = m11 * m22 - m12 * m12
        np.testing.assert_allclose(np.asarray(u), (m22 * h1 - m12 * h2) / det,
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(v), (m11 * h2 - m12 * h1) / det,
                                   rtol=1e-9, atol=1e-9)


class TestPolyExpansion:
    @pytest.mark.parametrize("n,sig", [(8, 1.2), (5, 1.1)])
    def test_matches_numpy_least_squares(self, n, sig):
        """poly_expansion == the per-pixel Gaussian-weighted quadratic
        least-squares fit in f64 (replicate borders)."""
        import jax.numpy as jnp

        from tpuflow.solvers.farneback import poly_expansion

        r = np.random.default_rng(1)
        img = r.uniform(0, 255, (30, 44))
        out = poly_expansion(jnp.asarray(img), n, sig)
        xs = np.arange(-n, n + 1, dtype=np.float64)
        g = np.exp(-(xs**2) / (2 * sig**2))
        g /= g.sum()
        X, Y = np.meshgrid(xs, xs)
        B = np.stack([np.ones_like(X), X, Y, X**2, Y**2, X * Y],
                     axis=-1).reshape(-1, 6)
        W = np.outer(g, g).reshape(-1)
        p = np.pad(img, n, mode="edge")
        for y, x in [(0, 0), (15, 20), (29, 43), (3, 40)]:
            f = p[y : y + 2 * n + 1, x : x + 2 * n + 1].reshape(-1)
            c = np.linalg.solve(B.T @ (W[:, None] * B), B.T @ (W * f))
            want = (c[1], c[2], c[3], c[4], c[5] * 0.5)
            got = [float(np.asarray(a)[y, x]) for a in out]
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


def _tile_reference(gx, gy, gt, inv, iterations, window_size, blocking):
    """The CUDA kernel's launch sequence in jnp: per launch, every
    (th, tw) tile runs up to K sweeps on its (K*r)-halo tile from the
    previous launch's frame, ``blocking`` = (K, th, tw)."""
    import jax.numpy as jnp

    from tpuflow.ops.stencil import hs_sweeps, inside_mask

    k, th, tw = blocking
    r = window_size // 2
    h, w = gx.shape
    halo = k * r
    nty, ntx = -(-h // th), -(-w // tw)
    hp, wp = nty * th, ntx * tw

    def pad(a):
        return jnp.pad(a, ((halo, hp - h + halo), (halo, wp - w + halo)))

    fields = [pad(a) for a in (gx, gy, gt, inv)]
    u = v = jnp.zeros((h, w), gx.dtype)
    for b in range(-(-iterations // k)):
        n = min(k, iterations - b * k)
        up, vp = pad(u), pad(v)
        rows = []
        for i in range(nty):
            cols = []
            for j in range(ntx):
                sl = (slice(i * th, i * th + th + 2 * halo),
                      slice(j * tw, j * tw + tw + 2 * halo))
                m = inside_mask(i * th - halo, j * tw - halo, th + 2 * halo,
                                tw + 2 * halo, h, w, gx.dtype)
                cu, cv = hs_sweeps(up[sl] * m, vp[sl] * m,
                                   *(f[sl] for f in fields), m,
                                   window_size, n)
                c = halo - n * r  # core offset inside the swept region
                cols.append((cu[c : c + th, c : c + tw],
                             cv[c : c + th, c : c + tw]))
            rows.append((jnp.concatenate([t[0] for t in cols], axis=1),
                         jnp.concatenate([t[1] for t in cols], axis=1)))
        u = jnp.concatenate([t[0] for t in rows], axis=0)[:h, :w]
        v = jnp.concatenate([t[1] for t in rows], axis=0)[:h, :w]
    return u, v


class TestHsKernelHost:
    """Host side of tpuflow.kernels.hs_cuda (the kernel needs the card)."""

    @pytest.mark.parametrize("blocking", [hs_cuda.BLOCKING, (2, 32, 128),
                                          (4, 16, 32)])
    def test_tile_reference_matches_oracle(self, blocking):
        """The kernel's blocked launch sequence (halo tiles, shrinking
        sweeps, ping-pong, remainder launch) == whole-frame sweeps; the
        first case is the compiled blocking (hs_cuda.BLOCKING)."""
        import jax.numpy as jnp

        from tpuflow.solvers.horn_schunck import hs_gradients

        r = np.random.default_rng(5)
        h, w = 40, 150  # several tiles, ragged right/bottom edges
        prev = r.uniform(0, 255, (h, w))
        nxt = np.roll(prev, 1, axis=1)
        gx, gy, gt = hs_gradients(jnp.asarray(prev), jnp.asarray(nxt))
        inv = 1.0 / (1.0 + gx * gx + gy * gy)
        u, v = _tile_reference(gx, gy, gt, inv, 11, 5, blocking)
        uo, vo = horn_schunck_oracle(prev, nxt, 5, 11, 1.0)
        np.testing.assert_allclose(np.asarray(u), uo, rtol=0, atol=1e-9)
        np.testing.assert_allclose(np.asarray(v), vo, rtol=0, atol=1e-9)

    def test_constants_match_source(self):
        src = hs_cuda.SOURCE.read_text()
        radii = tuple(int(r) for r in re.findall(
            r"run_sweeps<(\d+), kBlockSweeps, kTileH, kTileW>", src))
        assert radii == hs_cuda.RADII
        consts = [int(re.search(rf"#define {n} (\d+)\n", src)[1])
                  for n in ("HS_BLOCK_SWEEPS", "HS_TILE_H", "HS_TILE_W")]
        assert tuple(consts) == hs_cuda.BLOCKING

    def test_supports(self):
        import jax.numpy as jnp

        from tpuflow.kernels.hs_cuda import supports

        assert supports(5, jnp.float32)
        assert supports(3, jnp.float32) and supports(7, jnp.float32)
        assert not supports(5, jnp.float64)
        assert not supports(9, jnp.float32)
        assert not supports(4, jnp.float32)

    def test_unsupported_window_raises(self):
        import jax.numpy as jnp

        from tpuflow.kernels.hs_cuda import hs_sweeps_cuda

        z = jnp.zeros((8, 8), jnp.float32)
        with pytest.raises(ValueError, match="no HS kernel"):
            hs_sweeps_cuda(z, z, z, z, 4, 9)
        with pytest.raises(ValueError, match="no HS kernel"):
            hs_sweeps_cuda(z.astype(jnp.float64), z, z, z, 4, 5)

    def test_build_command_and_failure(self, tmp_path, monkeypatch):
        """nvcc targets sm_90a into the build dir; a failed build
        raises (no fallback)."""
        cmd = hs_cuda.nvcc_command(hs_cuda.SOURCE, tmp_path / "x.so")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert str(hs_cuda.SOURCE) == cmd[-1]
        lib = hs_cuda.library_path(tmp_path)
        assert lib.parent == tmp_path and lib.suffix == ".so"
        monkeypatch.setattr(hs_cuda, "nvcc_command",
                            lambda src, out: ["false"])
        with pytest.raises(RuntimeError, match="nvcc failed"):
            hs_cuda.build(tmp_path)
        assert not lib.exists()

    def test_dispatch(self, monkeypatch):
        """horn_schunck takes the kernel only where the backend says so
        and the kernel implements the window and dtype."""
        import importlib

        import jax.numpy as jnp

        from tpuflow.core import backend

        hs_mod = importlib.import_module("tpuflow.solvers.horn_schunck")

        calls = []
        monkeypatch.setattr(hs_mod, "horn_schunck_kernel",
                            lambda *a: calls.append("kernel") or "k")
        monkeypatch.setattr(hs_mod, "horn_schunck_conv",
                            lambda *a: calls.append("conv") or "c")
        f32 = jnp.zeros((8, 8), jnp.float32)
        f64 = jnp.zeros((8, 8), jnp.float64)
        assert hs_mod.horn_schunck(f32, f32) == "c"  # cpu
        monkeypatch.setattr(backend, "paths",
                            lambda name=None: backend._PATHS["gpu"])
        assert hs_mod.horn_schunck(f32, f32) == "k"
        assert hs_mod.horn_schunck(f64, f64) == "c"
        assert hs_mod.horn_schunck(f32, f32, 9) == "c"
        assert calls == ["conv", "kernel", "conv", "conv"]

    def test_vmap_on_simulated_gpu(self, monkeypatch):
        """Batched callers trace on the GPU path: the FFI call runs once
        per batch element (vmap_method="sequential")."""
        import jax
        import jax.numpy as jnp

        from tpuflow.solvers import horn_schunck

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(hs_cuda, "_library", lambda: None)
        p = jnp.zeros((2, 16, 24), jnp.float32)
        closed = jax.make_jaxpr(jax.vmap(
            lambda a, b: horn_schunck(a, b, 5, 8, 1.0)))(p, p)
        assert [o.aval.shape for o in closed.jaxpr.outvars] == [
            (2, 16, 24), (2, 16, 24)]
        assert "ffi_call" in str(closed)
