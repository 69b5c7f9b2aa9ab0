"""Seeded synthetic frames with known motion.

A scene is two textured layers: a background that translates by ``bg``
pixels per frame, and a foreground rectangle with its own texture that
translates by ``fg`` and occludes the background along its edges. Both
textures are sums of random plane waves over several octaves (periods
of 6 to 96 px by default), so any subpixel translation is sampled exactly and the
true flow is known everywhere: ``frame_t(x) = frame_{t+1}(x + flow(x))``
with ``flow = fg`` inside the rectangle of frame t and ``bg`` outside
(the forward-flow convention of OpenCV's Farneback).

Frames are 8-bit gray levels (0..255) in float64, or (H, W, 3) RGB with
``channels=3``. Generation is NumPy only: every (H, W) wave is the
rank-2 outer product cos(a) cos(b) - sin(a) sin(b) of 1-D factors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_WAVES = 48
_CONTRAST = 38.0  # standard deviation of a texture, in gray levels


@dataclass
class Waves:
    """Random plane waves: frequencies (cycles/px), phases, amplitudes."""

    fx: np.ndarray  # (channels, n)
    fy: np.ndarray
    phase: np.ndarray
    amp: np.ndarray

    @classmethod
    def random(cls, rng: np.random.Generator, channels: int,
               periods: tuple[float, float]) -> "Waves":
        shape = (channels, _WAVES)
        period = np.exp(rng.uniform(np.log(periods[0]), np.log(periods[1]),
                                    shape))
        theta = rng.uniform(0.0, np.pi, shape)
        amp = np.sqrt(period)  # coarser octaves carry more energy
        amp *= _CONTRAST * np.sqrt(2.0) / np.sqrt(
            (amp**2).sum(axis=1, keepdims=True))
        return cls(fx=np.cos(theta) / period, fy=np.sin(theta) / period,
                   phase=rng.uniform(0.0, 2 * np.pi, shape), amp=amp)

    def render(self, h: int, w: int, dx: float = 0.0,
               dy: float = 0.0) -> np.ndarray:
        """Texture sampled at (x - dx, y - dy): (channels, h, w)."""
        x = np.arange(w, dtype=np.float64) - dx
        y = np.arange(h, dtype=np.float64) - dy
        out = np.empty((self.fx.shape[0], h, w))
        for c in range(self.fx.shape[0]):
            a = 2 * np.pi * self.fx[c][:, None] * x[None, :] \
                + self.phase[c][:, None]                          # (n, w)
            b = 2 * np.pi * self.fy[c][:, None] * y[None, :]      # (n, h)
            amp = self.amp[c][:, None]
            out[c] = ((np.cos(b) * amp).T @ np.cos(a)
                      - (np.sin(b) * amp).T @ np.sin(a))
        return out


@dataclass
class Scene:
    """A layered scene: render frame t with :meth:`frame`."""

    h: int
    w: int
    bg: tuple[float, float]
    fg: tuple[float, float]
    box: tuple[int, int, int, int]  # (x0, y0, x1, y1) of the fg at t = 0
    back: Waves
    front: Waves
    tint: np.ndarray | None  # (3,) per-channel gain of the fg (RGB)

    def fg_mask(self, t: float) -> np.ndarray:
        """Pixels of frame t covered by the foreground box."""
        x0, y0, x1, y1 = self.box
        ox, oy = self.fg[0] * t, self.fg[1] * t
        xs = np.arange(self.w) - ox
        ys = np.arange(self.h) - oy
        return (((ys >= y0) & (ys < y1))[:, None]
                & ((xs >= x0) & (xs < x1))[None, :])

    def frame(self, t: float) -> np.ndarray:
        bx, by = self.bg[0] * t, self.bg[1] * t
        fx, fy = self.fg[0] * t, self.fg[1] * t
        back = self.back.render(self.h, self.w, bx, by)
        front = self.front.render(self.h, self.w, fx, fy)
        if self.tint is not None:
            front = front * self.tint[:, None, None]
        img = np.where(self.fg_mask(t)[None], front, back) + 128.0
        img = np.clip(np.round(img), 0.0, 255.0)
        return img[0] if img.shape[0] == 1 else np.moveaxis(img, 0, -1)

    def flow(self, t: float) -> tuple[np.ndarray, np.ndarray]:
        """True forward flow (u, v) from frame t to frame t + 1."""
        m = self.fg_mask(t)
        u = np.where(m, self.fg[0], self.bg[0])
        v = np.where(m, self.fg[1], self.bg[1])
        return u, v


def layered_scene(h: int, w: int, seed: int = 0,
                  bg: tuple[float, float] = (1.0, 0.5),
                  fg: tuple[float, float] = (-2.0, 1.0),
                  channels: int = 1,
                  periods: tuple[float, float] = (6.0, 96.0)) -> Scene:
    """A seeded two-layer scene; the foreground box covers the middle
    third of each axis. ``periods`` bounds the texture's wave periods in
    px: coarser textures segment into fewer mean-shift regions (at
    1242x375, (12, 192) gives ~1100, near a real KITTI frame's ~1800;
    the default gives ~7800)."""
    rng = np.random.default_rng(seed)
    back = Waves.random(rng, channels, periods)
    front = Waves.random(rng, channels, periods)
    tint = rng.uniform(0.6, 1.4, 3) if channels == 3 else None
    box = (w // 3, h // 3, w - w // 3, h - h // 3)
    return Scene(h=h, w=w, bg=tuple(map(float, bg)),
                 fg=tuple(map(float, fg)), box=box, back=back,
                 front=front, tint=tint)


def layered_pair(h: int, w: int, seed: int = 0,
                 bg: tuple[float, float] = (1.0, 0.5),
                 fg: tuple[float, float] = (-2.0, 1.0),
                 channels: int = 1):
    """(prev, next, u, v): frames 0 and 1 of :func:`layered_scene` and
    the true flow between them."""
    scene = layered_scene(h, w, seed, bg, fg, channels)
    u, v = scene.flow(0)
    return scene.frame(0), scene.frame(1), u, v
