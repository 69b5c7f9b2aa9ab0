"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so the multi-device
shard_map paths are exercised without accelerators (SURVEY.md §4d), and
with x64 enabled so golden-EPE comparisons against the float64 NumPy
oracle are meaningful. Test workers never initialise a GPU: the platform
is pinned to the CPU before jax is imported
(tests/test_backend.py::test_conftest_pins_cpu asserts it).
"""

import os

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Background bucket pre-warm threads would race pytest teardown and
# slow the suite with compiles of neighbor buckets no test requests;
# tests/test_streaming.py exercises the prewarm path synchronously.
os.environ.setdefault("TPUFLOW_NO_PREWARM", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def kitti_pair():
    """A KITTI-shaped (375 x 1242) gray pair with known motion: the
    seeded layered scene of tpuflow.core.synthetic (background (1, 0.5)
    px, an occluding foreground box moving (-2, 1) px), float64 gray
    levels. chip_smoke.py draws its 1242x375 frames from the same
    generator."""
    from tpuflow.core.synthetic import layered_pair

    prev, nxt, _, _ = layered_pair(375, 1242, seed=0)
    return prev, nxt


@pytest.fixture(scope="session")
def small_pair(kitti_pair):
    """A cropped pair for fast iteration-heavy tests."""
    p, n = kitti_pair
    return p[100:164, 300:380].copy(), n[100:164, 300:380].copy()
