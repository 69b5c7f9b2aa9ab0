"""Backend dispatch, the CPU pin of the test workers, the compile-cache
placement, and float32 exactness (HIGHEST precision) of every dot and
conv on the paths the GPU runs."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest

from tpuflow.core import backend

REPO = Path(__file__).resolve().parent.parent


def test_conftest_pins_cpu():
    """Test workers never initialise a GPU (one process per card)."""
    assert os.environ["JAX_PLATFORMS"] == "cpu"
    assert jax.config.jax_platforms == "cpu"
    assert {d.platform for d in jax.devices()} == {"cpu"}


def test_cpu_picks_plain_paths():
    p = backend.paths()
    assert p == backend.paths("cpu")
    assert not p.hs_kernel


def test_gpu_paths_and_unknown_platform(monkeypatch):
    gpu = backend.paths("gpu")
    assert gpu.hs_kernel
    with pytest.raises(RuntimeError, match="unsupported"):
        backend.paths("rocm")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.paths() == gpu
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported"):
        backend.paths()


def _primitives(jaxpr, out=None):
    """Every equation of a closed jaxpr, sub-jaxprs included."""
    out = [] if out is None else out
    for eqn in jaxpr.eqns:
        out.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _primitives(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _primitives(sub, out)
    return out


def _assert_highest(closed, min_count=1):
    eqns = [e for e in _primitives(closed.jaxpr)
            if e.primitive.name in ("dot_general", "conv_general_dilated")]
    assert len(eqns) >= min_count
    for e in eqns:
        prec = e.params["precision"]
        precs = prec if isinstance(prec, tuple) else (prec, prec)
        assert all(p == jax.lax.Precision.HIGHEST for p in precs), (
            e.primitive.name, prec)
    return eqns


def _matcher_args(h=20, w=24, n_regions=3):
    rng = np.random.default_rng(0)
    cur = jnp.asarray(rng.uniform(0, 1, (h, w, 3)), jnp.float32)
    ref = jnp.asarray(rng.uniform(0, 1, (h, w, 3)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, n_regions, (h, w)), jnp.int32)
    from tpuflow.blockmatching.matcher import _padded_candidates

    return cur, ref, labels, n_regions, jnp.asarray(_padded_candidates(2, 8))


def test_conv2d_precision_highest():
    from tpuflow.ops.filters import conv2d, sep_conv2d
    from tpuflow.pyramid.pyramid import pyramider

    img = jnp.zeros((16, 20), jnp.float32)
    k = jnp.ones((3, 3), jnp.float32)
    _assert_highest(jax.make_jaxpr(lambda a: conv2d(a, k))(img))
    _assert_highest(jax.make_jaxpr(
        lambda a: sep_conv2d(a, np.ones(5), np.ones(3)))(img))
    _assert_highest(jax.make_jaxpr(lambda a: pyramider(a, 2))(img), 2)


def test_poly_expansion_precision_highest():
    from tpuflow.solvers.farneback import poly_expansion

    img = jnp.zeros((16, 20), jnp.float32)
    eqns = _assert_highest(
        jax.make_jaxpr(lambda a: poly_expansion(a, 5, 1.1))(img), 7)
    assert any(e.primitive.name == "dot_general" for e in eqns)


@pytest.mark.parametrize("dot_dtype", [None, jnp.bfloat16])
def test_matcher_precision_highest(dot_dtype):
    from tpuflow.blockmatching.matcher import (
        _integer_costs_matmul,
        _integer_costs_matmul_bidi,
    )

    cur, ref, labels, n, cand = _matcher_args()
    one = jax.make_jaxpr(lambda c, r: _integer_costs_matmul(
        c, r, labels, n, cand, 1.0, 0.5, 8, 2, dot_dtype))(cur, ref)
    assert len(_assert_highest(one)) == 2
    bidi = jax.make_jaxpr(lambda c, r: _integer_costs_matmul_bidi(
        c, r, r, labels, n, cand, 1.0, 0.5, 8, 2, dot_dtype))(cur, ref)
    assert len(_assert_highest(bidi)) == 2


def test_simulated_gpu_traces_plain_paths(monkeypatch):
    """With the platform reported as gpu, the traced paths hold no
    Pallas call."""
    from tpuflow.blockmatching.matcher import _integer_costs_matmul
    from tpuflow.ops.filters import gaussian_filter
    from tpuflow.solvers.farneback import poly_expansion

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    img = jnp.zeros((16, 20), jnp.float32)
    cur, ref, labels, n, cand = _matcher_args()
    jaxprs = [
        jax.make_jaxpr(lambda a: poly_expansion(a, 5, 1.1))(img),
        jax.make_jaxpr(lambda a: gaussian_filter(a, (5, 5), 1.0))(img),
        jax.make_jaxpr(lambda c, r: _integer_costs_matmul(
            c, r, labels, n, cand, 1.0, 0.5, 8, 2, jnp.bfloat16))(cur, ref),
    ]
    names = {e.primitive.name for j in jaxprs for e in _primitives(j.jaxpr)}
    assert "pallas_call" not in names


def _cache_dir_in_child(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    code = ("import jax, tpuflow; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_unset_uses_checkout():
    import tpuflow

    assert tpuflow.CACHE_DIR == REPO / ".jax_cache"
    assert _cache_dir_in_child({}) == str(REPO / ".jax_cache")


def test_cache_dir_env_wins(tmp_path):
    assert _cache_dir_in_child(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)
