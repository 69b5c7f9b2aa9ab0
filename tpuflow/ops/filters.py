"""L1 image-ops: convolution, box/gaussian/epsilon filters, horizontal median.

Re-design of ``lib/ImgLibrary.cpp``: every op is expressed as
static-shape padded convolutions / windowed reductions that XLA fuses,
instead of the reference's OpenMP pixel loops. All ops are jit- and
vmap-able and dtype-polymorphic (f32 on the GPU, f64 for oracle
validation on CPU).

Semantics notes (behavioral contract with the reference):

- ``Filterer`` (ImgLibrary.cpp:408-464) is a *convolution* (kernel index
  flipped: reads ``Image(x + cx - n, y + cy - m)``) with either mirror or
  zero-pad borders and anchor ``(w//2, h//2)``.
- OpenCV ``filter2D`` as used by the HS demo (hornSchunck.cpp:60-61) is a
  *correlation* with BORDER_CONSTANT — covered by ``conv2d(..., flip=False,
  border="zero")``.
- ``EpsilonFilter`` (ImgLibrary.cpp:58-121): averaging where neighbors
  within epsilon of the center contribute their (mirrored) value, others
  contribute the center value.
- ``Gaussian`` (ImgLibrary.cpp:124-244): direct convolution with a square
  kernel, or a diamond-support kernel when an even size was requested
  (the reference bumps the size to odd and masks to a diamond).
- ``HorizontalMedian`` (ImgLibrary.cpp:8-55): median over a horizontal
  window, shrunk one-sidedly at the image borders. (The reference's loop
  ``for (m = m_s; m < m_e; m++)`` leaves the last window slot
  uninitialized — an out-of-bounds-read bug; we implement the intended
  inclusive window ``[m_s, m_e]``.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuflow.core import borders as bd


def _conv2d_valid(img: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """VALID correlation of (H, W) img with (kh, kw) kernel.

    HIGHEST precision: on the GPU a float32 convolution may otherwise run
    in TF32 (about three decimal digits)."""
    lhs = img[None, None, :, :]
    rhs = kernel[None, None, :, :].astype(img.dtype)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=img.dtype,
    )
    return out[0, 0]


def conv2d(
    img: jnp.ndarray,
    kernel: jnp.ndarray,
    border: str = bd.ZERO,
    flip: bool = False,
    anchor: tuple[int, int] | None = None,
) -> jnp.ndarray:
    """2-D filtering with explicit border policy and anchor.

    flip=False -> correlation (OpenCV filter2D), flip=True -> convolution
    (the reference's Filterer). ``anchor`` is (ax, ay) in *correlation*
    orientation; default is the kernel center ((kw-1)//2 after flip
    resolution), which matches both the reference and OpenCV defaults for
    odd kernels.
    """
    kernel = jnp.asarray(kernel)
    kh, kw = kernel.shape
    if flip:
        kernel = kernel[::-1, ::-1]
        # Filterer anchor: center (kw//2, kh//2) in conv orientation is
        # (kw-1-kw//2, kh-1-kh//2) in correlation orientation.
        if anchor is None:
            anchor = (kw - 1 - kw // 2, kh - 1 - kh // 2)
    if anchor is None:
        anchor = (kw // 2, kh // 2)
    ax, ay = anchor
    padded = bd.pad2d(img, (ay, kh - 1 - ay, ax, kw - 1 - ax), border)
    return _conv2d_valid(padded, kernel)


def sep_conv2d(
    img: jnp.ndarray,
    kx: jnp.ndarray,
    ky: jnp.ndarray,
    border: str = bd.ZERO,
) -> jnp.ndarray:
    """Separable correlation: rows with ky then columns with kx (odd
    taps), as one 2-D correlation with the outer-product kernel."""
    kx = jnp.asarray(kx)
    ky = jnp.asarray(ky)
    rx, ry = kx.shape[0] // 2, ky.shape[0] // 2
    padded = bd.pad2d(img, (ry, ry, rx, rx), border)
    out = _conv2d_valid(padded, ky[:, None].astype(img.dtype)
                        * kx[None, :].astype(img.dtype))
    return out


def filterer(img: jnp.ndarray, kernel: jnp.ndarray,
             mirroring: bool = False) -> jnp.ndarray:
    """Reference ``Filterer``: convolution, zero-pad or mirror borders."""
    return conv2d(img, kernel, border=bd.MIRROR if mirroring else bd.ZERO,
                  flip=True)


def box_filter(img: jnp.ndarray, size: int, border: str = bd.ZERO) -> jnp.ndarray:
    """size x size normalized box average (HS demo: size=5, BORDER_CONSTANT)."""
    k = jnp.full((size, size), 1.0 / (size * size), dtype=img.dtype)
    return conv2d(img, k, border=border, flip=False)


def gaussian_kernel(size_wh: tuple[int, int], sigma: float,
                    dtype=jnp.float32) -> jnp.ndarray:
    """Gaussian kernel per ImgLibrary.cpp:136-210.

    Even requested sizes are bumped to odd with a diamond support mask;
    normalized to sum 1. Returns (kh, kw).
    """
    w, h = size_wh
    diamond = (w % 2 == 0) or (h % 2 == 0)
    if w % 2 == 0:
        w += 1
    if h % 2 == 0:
        h += 1
    w2, h2 = w // 2, h // 2
    n = jnp.arange(w, dtype=dtype)[None, :]
    m = jnp.arange(h, dtype=dtype)[:, None]
    g = jnp.exp(-((m - h2) ** 2 + (n - w2) ** 2) / (2.0 * sigma**2))
    if diamond:
        mask = (w2 * jnp.abs(m - h2) + h2 * jnp.abs(n - w2)) <= w2 * h2
        g = jnp.where(mask, g, 0.0)
    return g / jnp.sum(g)


def gaussian_filter(img: jnp.ndarray, size_wh: tuple[int, int],
                    sigma: float) -> jnp.ndarray:
    """Reference ``Gaussian``: direct conv, zero-pad borders (ImgVector::get
    out-of-range reads resolve to 0 — submodule behavior, SURVEY.md §2.4)."""
    w, h = size_wh
    if w % 2 == 1 and h % 2 == 1:
        # Square odd kernels are exactly separable. Normalizing the
        # outer product to sum 1 equals normalizing each factor by its
        # own sum.
        import numpy as np

        xs = np.arange(w, dtype=np.float64) - w // 2
        ysv = np.arange(h, dtype=np.float64) - h // 2
        kx1 = np.exp(-(xs**2) / (2.0 * sigma**2))
        ky1 = np.exp(-(ysv**2) / (2.0 * sigma**2))
        return sep_conv2d(img, kx1 / kx1.sum(), ky1 / ky1.sum(),
                          border=bd.ZERO)
    k = gaussian_kernel(size_wh, sigma, dtype=img.dtype)
    # Reference loops  img.get(n + x, m + y) * Gauss.get(x + w2, y + h2)
    # which is a correlation with the (symmetric) kernel.
    return conv2d(img, k, border=bd.ZERO, flip=False)


def epsilon_filter(img: jnp.ndarray, size_wh: tuple[int, int],
                   epsilon: float) -> jnp.ndarray:
    """Edge-preserving epsilon filter (ImgLibrary.cpp:100-115).

    out(x,y) = mean over window of { mirror(img)(x+f) if
    |img(x,y) - zeropad(img)(x+f)| <= eps else img(x,y) }.
    """
    w, h = size_wh
    if w % 2 == 0 or h % 2 == 0 or w <= 0 or h <= 0:
        raise ValueError("epsilon filter size must be odd and positive")
    w2, h2 = w // 2, h // 2
    pz = bd.pad2d(img, (h2, h2, w2, w2), bd.ZERO)
    pm = bd.pad2d(img, (h2, h2, w2, w2), bd.MIRROR)
    H, W = img.shape
    acc = jnp.zeros_like(img)
    # Static unrolled window accumulation: XLA fuses this into one pass.
    for fy in range(h):
        for fx in range(w):
            nz = jax.lax.dynamic_slice(pz, (fy, fx), (H, W))
            nm = jax.lax.dynamic_slice(pm, (fy, fx), (H, W))
            take = jnp.abs(img - nz) <= epsilon
            acc = acc + jnp.where(take, nm, img)
    return acc / (w * h)


def horizontal_median(img: jnp.ndarray, width: int) -> jnp.ndarray:
    """Median over a horizontal window of ``width`` pixels.

    Matches the *intended* HorizontalMedian (ImgLibrary.cpp:8-55): interior
    window [x-(w-1)//2, x+w//2]; at the left border the window is [0, w//2],
    at the right border [x-(w-1)//2, W-1]; even-length windows average the
    two central order statistics.
    """
    H, W = img.shape
    lo = width // 2          # taps to the right
    hi = (width - 1) // 2    # taps to the left
    k = lo + hi + 1
    big = jnp.asarray(jnp.inf, img.dtype)
    padded = bd.pad2d(img, (0, 0, hi, lo), bd.ZERO)
    cols = jnp.stack(
        [jax.lax.dynamic_slice(padded, (0, i), (H, W)) for i in range(k)],
        axis=-1)  # (H, W, k)
    x = jnp.arange(W)
    # Number of valid taps per column and validity mask per tap.
    off = jnp.arange(k) - hi  # window offsets
    valid = (x[:, None] + off[None, :] >= 0) & (x[:, None] + off[None, :] < W)
    cols = jnp.where(valid[None, :, :], cols, big)  # invalid -> +inf, sort right
    srt = jnp.sort(cols, axis=-1)
    L = jnp.sum(valid, axis=-1)  # (W,)
    mid_hi = L // 2
    mid_lo = (L - 1) // 2
    g_hi = jnp.take_along_axis(srt, jnp.broadcast_to(mid_hi[None, :, None], (H, W, 1)), axis=-1)[..., 0]
    g_lo = jnp.take_along_axis(srt, jnp.broadcast_to(mid_lo[None, :, None], (H, W, 1)), axis=-1)[..., 0]
    return 0.5 * (g_hi + g_lo)
