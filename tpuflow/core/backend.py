"""Backend dispatch: the one place that maps a JAX platform to code paths.

tpuflow runs on two JAX platforms. On ``cpu`` every solver takes its
plain jnp/XLA path (the one the float64 oracle tests pin). On ``gpu``
the same plain paths run, plus the hand-written CUDA kernels that beat
XLA there on the card. Any other platform is an error, not a default.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax

PLATFORMS = ("cpu", "gpu")


@dataclass(frozen=True)
class Paths:
    """Code paths chosen for one platform."""

    #: Horn-Schunck's Jacobi sweeps run in the temporally blocked CUDA
    #: kernel (:mod:`tpuflow.kernels.hs_cuda`) for float32 frames.
    hs_kernel: bool


_PATHS = {
    "cpu": Paths(hs_kernel=False),
    "gpu": Paths(hs_kernel=True),
}


def paths(platform: str | None = None) -> Paths:
    """Code paths for ``platform`` (default: the process's JAX backend)."""
    platform = jax.default_backend() if platform is None else platform
    if platform not in _PATHS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}; tpuflow runs on "
            f"{PLATFORMS}")
    return _PATHS[platform]
