"""Native (C++) I/O runtime: PNM/flow codecs + threaded frame prefetcher.

The compute path is JAX/XLA; this is the host-side runtime around
it — the equivalent of the reference's C++ I/O layer (pnm_lib_cpp) plus
the ahead-of-device data loader an accelerator pipeline needs. Built on first use
with g++ (cached as _libtpuflow_io.so next to the source); ctypes ABI.

Falls back cleanly: callers should catch ImportError/OSError from
:func:`load_library` and use the pure-Python codecs in
:mod:`tpuflow.core.io`.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "io_native.cpp"
_LIB = _DIR / "_libtpuflow_io.so"

_lib = None


class TfImage(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("maxval", ctypes.c_int32),
        ("data", ctypes.POINTER(ctypes.c_double)),
    ]


def build_library(force: bool = False) -> Path:
    """Compile io_native.cpp -> _libtpuflow_io.so (g++ -O3, pthread)."""
    if _LIB.exists() and not force \
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(_SRC), "-o", str(_LIB)]
    subprocess.run(cmd, check=True, capture_output=True)
    return _LIB


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    build_library()
    lib = ctypes.CDLL(str(_LIB))
    lib.tf_read_pnm.restype = ctypes.POINTER(TfImage)
    lib.tf_read_pnm.argtypes = [ctypes.c_char_p]
    lib.tf_write_pnm.restype = ctypes.c_int
    lib.tf_write_pnm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.tf_free_image.argtypes = [ctypes.POINTER(TfImage)]
    lib.tf_write_flow.restype = ctypes.c_int
    lib.tf_write_flow.argtypes = [ctypes.c_char_p] \
        + [ctypes.POINTER(ctypes.c_double)] * 3 \
        + [ctypes.c_int32, ctypes.c_int32]
    lib.tf_flow_size.restype = ctypes.c_int
    lib.tf_flow_size.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int32)]
    lib.tf_read_flow.restype = ctypes.c_int
    lib.tf_read_flow.argtypes = [ctypes.c_char_p] \
        + [ctypes.POINTER(ctypes.c_double)] * 3 \
        + [ctypes.c_int32, ctypes.c_int32]
    lib.tf_draw_quiver.restype = None
    lib.tf_draw_quiver.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    lib.tf_prefetcher_create.restype = ctypes.c_void_p
    lib.tf_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32]
    lib.tf_prefetcher_next.restype = ctypes.POINTER(TfImage)
    lib.tf_prefetcher_next.argtypes = [ctypes.c_void_p]
    lib.tf_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.tf_label_regions.restype = ctypes.c_int32
    lib.tf_label_regions.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def label_regions(pos: np.ndarray, col: np.ndarray, kernel_spatial: float,
                  kernel_intensity: float, min_size: int):
    """Native mean-shift region formation (tf_label_regions): 4-adjacent
    mode merge + tiny-region absorption — bit-identical to the Python
    tpuflow.segmentation.meanshift._merge_labels. Returns (labels, n)."""
    lib = load_library()
    h, w = pos.shape[:2]
    pos = np.ascontiguousarray(pos, np.float64)
    col = np.ascontiguousarray(col, np.float64)
    out = np.empty((h, w), np.int32)
    n = lib.tf_label_regions(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        h, w, (0.5 * float(kernel_spatial)) ** 2,
        float(kernel_intensity) ** 2, int(min_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, int(n)


def _image_to_numpy(lib, img_ptr) -> tuple[np.ndarray, int]:
    img = img_ptr.contents
    count = img.width * img.height * img.channels
    arr = np.ctypeslib.as_array(img.data, shape=(count,)).copy()
    if img.channels == 3:
        arr = arr.reshape(img.height, img.width, 3)
    else:
        arr = arr.reshape(img.height, img.width)
    maxval = img.maxval
    lib.tf_free_image(img_ptr)
    return arr, maxval


def read_pnm(path) -> tuple[np.ndarray, int]:
    """Native P5/P6 decode -> (float64 array, maxval)."""
    lib = load_library()
    ptr = lib.tf_read_pnm(str(path).encode())
    if not ptr:
        raise IOError(f"tf_read_pnm failed for {path}")
    return _image_to_numpy(lib, ptr)


def write_pnm(path, img: np.ndarray, maxval: int = 255) -> None:
    lib = load_library()
    img = np.ascontiguousarray(img, dtype=np.float64)
    channels = 3 if img.ndim == 3 else 1
    h, w = img.shape[:2]
    rc = lib.tf_write_pnm(
        str(path).encode(),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        w, h, channels, maxval)
    if rc != 0:
        raise IOError(f"tf_write_pnm failed for {path}")


def write_flow(path, u: np.ndarray, v: np.ndarray,
               score: np.ndarray | None = None) -> None:
    lib = load_library()
    u = np.ascontiguousarray(u, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    h, w = u.shape
    sp = None
    if score is not None:
        score = np.ascontiguousarray(score, dtype=np.float64)
        sp = score.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.tf_write_flow(
        str(path).encode(),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sp, w, h)
    if rc != 0:
        raise IOError(f"tf_write_flow failed for {path}")


def read_flow(path, components: int = 2):
    lib = load_library()
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    if lib.tf_flow_size(str(path).encode(), ctypes.byref(w),
                        ctypes.byref(h)) != 0:
        raise IOError(f"tf_flow_size failed for {path}")
    u = np.empty((h.value, w.value), np.float64)
    v = np.empty((h.value, w.value), np.float64)
    s = np.empty((h.value, w.value), np.float64) if components == 3 else None
    rc = lib.tf_read_flow(
        str(path).encode(),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if s is not None else None,
        w.value, h.value)
    if rc != 0:
        raise IOError(f"tf_read_flow failed for {path}")
    return (u, v, s) if s is not None else (u, v)


class FramePrefetcher:
    """Threaded ahead-of-device PNM loader with ordered delivery.

    Usage::

        with FramePrefetcher(paths, threads=4) as pf:
            for frame, maxval in pf:
                ...
    """

    def __init__(self, paths, threads: int = 2, capacity: int = 4):
        self.lib = load_library()
        self.paths = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self.lib.tf_prefetcher_create(
            arr, len(self.paths), threads, capacity)
        self._emitted = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._handle:
            self.lib.tf_prefetcher_destroy(self._handle)
            self._handle = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._emitted >= len(self.paths):
            raise StopIteration
        ptr = self.lib.tf_prefetcher_next(self._handle)
        self._emitted += 1
        if not ptr:
            raise IOError(
                f"prefetcher failed to decode {self.paths[self._emitted - 1]}")
        return _image_to_numpy(self.lib, ptr)


def draw_quiver(img_rgb: np.ndarray, u: np.ndarray, v: np.ndarray,
                delta: int = 10, scale: float = 1.0,
                outlier: float = 0.0,
                line_color=(0, 255, 0), tip_color=(255, 0, 0)) -> np.ndarray:
    """Native Bresenham quiver rasterization (plotFlow.cpp semantics);
    returns a new (H, W, 3) uint8 array."""
    lib = load_library()
    out = np.ascontiguousarray(img_rgb, dtype=np.uint8).copy()
    u = np.ascontiguousarray(u, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    h, w = u.shape
    lc = (ctypes.c_uint8 * 3)(*line_color)
    tc = (ctypes.c_uint8 * 3)(*tip_color)
    lib.tf_draw_quiver(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        delta, scale, outlier, lc, tc)
    return out
