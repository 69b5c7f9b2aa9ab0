"""Device mesh construction for 2-D image-domain tiling.

The reference's only parallelism is OpenMP ``parallel for`` over pixel rows
/ sites (SURVEY.md §2.6); the multi-device equivalent is a 2-D mesh
``("ty", "tx")`` over the devices with each device owning an image tile.
The GPUs of one host reach each other all to all over NVLink, so the
mesh follows the algorithm alone: :func:`make_mesh` takes the first N
devices in order. Across hosts the same code runs under
``jax.distributed`` initialization (single-program multi-host).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh


def mesh_factor(n: int) -> tuple[int, int]:
    """Factor n into (ty, tx) as near-square as possible, tx >= ty."""
    ty = int(math.isqrt(n))
    while n % ty != 0:
        ty -= 1
    return ty, n // ty


def make_mesh(n_devices: int | None = None,
              devices=None,
              axis_names: tuple[str, str] = ("ty", "tx")) -> Mesh:
    """A 2-D (ty, tx) mesh over the first n_devices devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    ty, tx = mesh_factor(n_devices)
    arr = np.array(devices[:n_devices]).reshape(ty, tx)
    return Mesh(arr, axis_names)
