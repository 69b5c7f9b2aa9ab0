"""Gaussian pyramid + per-level derivative fields + coarse-to-fine plumbing.

Re-design of ``OpticalFlow/MultiResolution.cpp`` and the coarse-to-fine
helpers in ``OpticalFlow/OpticalFlow.cpp``:

- :func:`pyramider` — 5-tap separable low-pass (w = [a/2, .5, a, .5, a/2]/1.8,
  a = 0.4; note the reference normalizes by the *sum* 1.8,
  MultiResolution.cpp:50-62), mirrored borders, x2 downsampling with
  ceil-sized levels (MultiResolution.cpp:40-41). Implemented as one strided
  conv per level — no gathers.
- :func:`grad_pyramid` — 2x2 forward-difference average gradient with the
  last-row/col clamp (SATURATE to size-2, MultiResolution.cpp:129-158),
  optionally summing both frames' gradients (used by the affine path).
- :func:`dt_pyramid` — 4-tap temporal difference (MultiResolution.cpp:197-212).
- :func:`level_down` — recompute dt under the x2-scaled coarse flow
  (floor(2u) zero-pad gather, OpticalFlow.cpp:169-193).
- :func:`add_vector_offset` — prolongation u += 2 * u_coarse(x/2, y/2)
  (OpticalFlow.cpp:196-210).

Pyramids are Python lists of (H_l, W_l) arrays — levels have static but
distinct shapes, so the per-level loop lives in Python (unrolled under jit)
while all pixel math is vectorized jnp.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.core import borders as bd

_A = 0.4
_W5 = np.array([_A / 2, 0.5, _A, 0.5, _A / 2]) / (1.0 + 2 * _A)
# sum = a/2 + .5 + a + .5 + a/2 = 1 + 2a = 1.8; the reference divides by it.


def pyramid_sizes(width: int, height: int, max_level: int) -> list[tuple[int, int]]:
    """Per-level (width, height): ceil(size / 2**l), stopping before zero."""
    sizes = [(width, height)]
    for lev in range(1, max_level + 1):
        w = math.ceil(width * 0.5**lev)
        h = math.ceil(height * 0.5**lev)
        if w <= 0 or h <= 0:
            break
        sizes.append((w, h))
    return sizes


def _downsample(img: jnp.ndarray, out_wh: tuple[int, int]) -> jnp.ndarray:
    """One pyramid level: mirrored 5x5 separable low-pass + stride-2.

    Output pixel (x, y) = sum_{m,n} w[m] w[n] mirror(img)[2y+m-2, 2x+n-2].
    """
    out_w, out_h = out_wh
    w5 = _W5.astype(img.dtype)
    # Pad so that index 2y+m-2 for y in [0, out_h), m in [0,5) is in range:
    # need rows [-2, 2*(out_h-1)+2] -> pad 2 at top, pad to cover bottom.
    need_h = 2 * (out_h - 1) + 3
    need_w = 2 * (out_w - 1) + 3
    pad_b = need_h - img.shape[0]
    pad_r = need_w - img.shape[1]
    p = bd.pad2d(img, (2, max(pad_b, 0), 2, max(pad_r, 0)), bd.MIRROR)
    lhs = p[None, None, :, :]
    rhs = (w5[:, None] * w5[None, :])[None, None, :, :]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(2, 2), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=img.dtype,
    )
    return out[0, 0, :out_h, :out_w]


def pyramider(img: jnp.ndarray, max_level: int) -> list[jnp.ndarray]:
    """Level 0 = img; level l = low-passed, x2-downsampled level l-1."""
    h, w = img.shape
    sizes = pyramid_sizes(w, h, max_level)
    levels = [img]
    for wl, hl in sizes[1:]:
        levels.append(_downsample(levels[-1], (wl, hl)))
    return levels


def _clamped_2x2_indices(h: int, w: int):
    x = jnp.clip(jnp.arange(w), 0, max(w - 2, 0))
    y = jnp.clip(jnp.arange(h), 0, max(h - 2, 0))
    return x[None, :], y[:, None]


def grad_level(img_t: jnp.ndarray, img_tp1: jnp.ndarray | None = None):
    """(gx, gy) 2x2 forward-difference average, clamped at the far edge."""
    h, w = img_t.shape
    x, y = _clamped_2x2_indices(h, w)

    def g(im):
        i00 = im[y, x]
        i10 = im[y, x + 1]
        i01 = im[y + 1, x]
        i11 = im[y + 1, x + 1]
        gx = (i10 - i00 + i11 - i01) / 2.0
        gy = (i01 - i00 + i11 - i10) / 2.0
        return gx, gy

    gx, gy = g(img_t)
    if img_tp1 is not None:
        gx2, gy2 = g(img_tp1)
        gx, gy = gx + gx2, gy + gy2
    return gx, gy


def grad_pyramid(levels_t, levels_tp1=None):
    if levels_tp1 is None:
        return [grad_level(lv) for lv in levels_t]
    return [grad_level(a, b) for a, b in zip(levels_t, levels_tp1)]


def dt_level(img_t: jnp.ndarray, img_tp1: jnp.ndarray) -> jnp.ndarray:
    h, w = img_t.shape
    x, y = _clamped_2x2_indices(h, w)
    d = img_tp1 - img_t
    return (d[y, x] + d[y, x + 1] + d[y + 1, x] + d[y + 1, x + 1]) / 4.0


def dt_pyramid(levels_t, levels_tp1):
    return [dt_level(a, b) for a, b in zip(levels_t, levels_tp1)]


def upsample_nearest(coarse: jnp.ndarray, out_hw: tuple[int, int]) -> jnp.ndarray:
    """coarse(x/2, y/2) lookup (integer-divide indexing, OpticalFlow.cpp:178)."""
    h, w = out_hw
    ch, cw = coarse.shape[-2], coarse.shape[-1]
    x = jnp.clip(jnp.arange(w) // 2, 0, cw - 1)
    y = jnp.clip(jnp.arange(h) // 2, 0, ch - 1)
    return coarse[..., y[:, None], x[None, :]]


def level_down(
    it_level: jnp.ndarray,
    itp1_level: jnp.ndarray,
    u_coarse: jnp.ndarray,
    v_coarse: jnp.ndarray,
) -> jnp.ndarray:
    """Recompute I_dt at this level under the x2-scaled coarse flow.

    dt(x,y) = mean over the 2x2 stencil of
      Itp1.zeropad(x + dx + floor(2 u_c), y + dy + floor(2 v_c))
      - It.zeropad(x + dx, y + dy)
    where (u_c, v_c) = coarse(x/2, y/2)  (OpticalFlow.cpp:176-191).
    """
    h, w = it_level.shape
    uo = upsample_nearest(u_coarse, (h, w))
    vo = upsample_nearest(v_coarse, (h, w))
    ox = jnp.floor(2.0 * uo).astype(jnp.int32)
    oy = jnp.floor(2.0 * vo).astype(jnp.int32)
    xs = jnp.arange(w)[None, :]
    ys = jnp.arange(h)[:, None]
    acc = jnp.zeros_like(it_level)
    for dy in (0, 1):
        for dx in (0, 1):
            tp1 = bd.gather2d(itp1_level, xs + dx + ox, ys + dy + oy, bd.ZERO)
            t0 = bd.gather2d(it_level, xs + dx + jnp.zeros_like(ox),
                             ys + dy + jnp.zeros_like(oy), bd.ZERO)
            acc = acc + (tp1 - t0)
    return acc / 4.0


def add_vector_offset(
    u: jnp.ndarray, v: jnp.ndarray, u_coarse: jnp.ndarray, v_coarse: jnp.ndarray
):
    """Prolongation: u += 2 * u_coarse(x/2, y/2) (OpticalFlow.cpp:196-210)."""
    h, w = u.shape
    return (
        u + 2.0 * upsample_nearest(u_coarse, (h, w)),
        v + 2.0 * upsample_nearest(v_coarse, (h, w)),
    )
