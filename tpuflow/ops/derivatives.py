"""Spatial derivative operators.

- ``sobel_opencv``: OpenCV-parity 3x3 Sobel (kernel [-1 0 1; -2 0 2; -1 0 1],
  correlation, BORDER_REFLECT_101) as used by the HS demo
  (``HornSchunckOF/hornSchunck.cpp:27-28``).
- ``derivator``: the reference ``Derivator`` (``lib/ImgLibrary.cpp:305-374``)
  — 2x2 "Normal" difference filters or 1/4-scaled Sobel, applied through the
  convolution-orientation ``Filterer`` with zero-pad borders.
- ``derivative_angler``: gradient orientation field in [0, 2) (units of pi),
  rotated by pi/2, with sentinel -2*ANGLE_MAX for flat pixels
  (``lib/ImgLibrary.cpp:247-302``). Feeds the a-contrario alignment search.
- ``derivation_abs``: gradient magnitude (``lib/ImgLibrary.cpp:377-405``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpuflow.core import borders as bd
from tpuflow.core.config import ANGLE_MAX
from tpuflow.ops.filters import conv2d, filterer

DERIVATIVE_MINIMUM = 0.0  # Scratch_MeaningfulMotion.h:123

# Module-level kernel taps stay NumPy: concrete at every trace and
# immune to aborted-trace tracer poisoning that device-resident module
# constants suffer.
_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
_SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]])

# Reference Derivator kernels (ImgLibrary.cpp:314-317), conv orientation.
_DIFF_X = np.array([[-0.5, 0.5], [-0.5, 0.5]])
_DIFF_Y = np.array([[-0.5, -0.5], [0.5, 0.5]])
_SOBEL_QX = 0.25 * _SOBEL_X
_SOBEL_QY = 0.25 * _SOBEL_Y


def sobel_opencv(img: jnp.ndarray, axis: str) -> jnp.ndarray:
    """OpenCV Sobel(ksize=3) with default BORDER_REFLECT_101."""
    k = _SOBEL_X if axis == "x" else _SOBEL_Y
    return conv2d(img, k.astype(img.dtype), border=bd.REFLECT101, flip=False)


def derivator(img: jnp.ndarray, type: str = "Normal",
              mirroring: bool = False) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reference Derivator -> (dx, dy)."""
    if type == "Normal":
        kx, ky = _DIFF_X, _DIFF_Y
    elif type == "Sobel":
        kx, ky = _SOBEL_QX, _SOBEL_QY
    else:
        raise ValueError(f"unknown derivator type {type}")
    dx = filterer(img, kx.astype(img.dtype), mirroring)
    dy = filterer(img, ky.astype(img.dtype), mirroring)
    return dx, dy


def derivation_abs(dx: jnp.ndarray, dy: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dx * dx + dy * dy)


def derivative_angler(img: jnp.ndarray) -> jnp.ndarray:
    """Orientation field: atan2(dy,dx)/pi + 0.5 wrapped to [0, ANGLE_MAX),
    sentinel -2*ANGLE_MAX where |dx|,|dy| <= DERIVATIVE_MINIMUM."""
    dx, dy = derivator(img, "Sobel")
    ang = jnp.arctan2(dy, dx) / jnp.pi + 0.5
    ang = jnp.where(ang > ANGLE_MAX, ang - ANGLE_MAX, ang)
    ang = jnp.where(ang < 0.0, ang + ANGLE_MAX, ang)
    flat = (jnp.abs(dx) <= DERIVATIVE_MINIMUM) & (jnp.abs(dy) <= DERIVATIVE_MINIMUM)
    return jnp.where(flat, -2.0 * ANGLE_MAX, ang)
