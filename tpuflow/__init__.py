"""tpuflow — a dense optical-flow framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
liuyang9609/Cpp-Optical-Flow (C++/OpenCV/OpenMP): dense variational flow
(Horn-Schunck, Black-Anandan robust IRLS), pyramidal Lucas-Kanade,
Farneback polynomial-expansion flow, segmentation-based block matching,
HOG features + matching, film-scratch detection via a-contrario meaningful
alignments, and the surrounding pipeline (streaming, warm start, motion
compensation, visualization, CLI).

Design: images are plain (H, W) or (H, W, C) jnp arrays (x = column,
y = row, matching the reference convention), all compute paths are
jit/vmap-able plain jnp that XLA compiles for the CPU or the GPU (one
backend dispatch, :mod:`tpuflow.core.backend`, adds a CUDA kernel where
it beats XLA on the card), and multi-device scaling is 2-D image-domain
tiling via shard_map + halo exchange (lax.ppermute) instead of the
reference's OpenMP threading.
"""

import os
from pathlib import Path

__version__ = "0.1.0"

#: Where compiled programs are kept when JAX_COMPILATION_CACHE_DIR is
#: unset: a fixed path in the checkout, so every process of one
#: checkout finds what another compiled.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def _enable_persistent_compile_cache() -> None:
    """Point JAX's persistent compilation cache at :data:`CACHE_DIR`.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; an explicit ``jax_compilation_cache_dir`` set
    before import also wins."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))


_enable_persistent_compile_cache()

from tpuflow.core import borders, color, config, io  # noqa: E402,F401
