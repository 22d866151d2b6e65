"""ctypes binding for the first-party C++ tile decoder (native/wsitile).

:class:`NativeSlide` implements the :class:`~wsiseg_tpu_torch.slides.reader.SlideReader`
protocol over pyramidal TIFF/SVS files (libtiff) and ``.wsiraw`` mmap
pyramids, replacing the reference's OpenSlide dependency (SURVEY.md §2.b).
The batched :meth:`read_tiles` decodes many tiles in parallel worker
threads into one contiguous array — the host side of the dense-inference
input pipeline.

The shared library is built on demand with ``make`` the first time it is
needed (no pip/apt involved; g++ + libtiff are part of the base image).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libwsitile.so")

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                   capture_output=True)


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) libwsitile and declare signatures."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _build_library()
        lib = ctypes.CDLL(_LIB_PATH)

        i64 = ctypes.c_int64
        p_i64 = ctypes.POINTER(i64)
        p_u8 = ctypes.POINTER(ctypes.c_uint8)

        lib.wsitile_open.restype = ctypes.c_void_p
        lib.wsitile_open.argtypes = [ctypes.c_char_p]
        lib.wsitile_close.argtypes = [ctypes.c_void_p]
        lib.wsitile_level_count.restype = ctypes.c_int
        lib.wsitile_level_count.argtypes = [ctypes.c_void_p]
        lib.wsitile_level_dimensions.restype = ctypes.c_int
        lib.wsitile_level_dimensions.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int, p_i64, p_i64]
        lib.wsitile_level_downsample.restype = ctypes.c_double
        lib.wsitile_level_downsample.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.wsitile_read_region.restype = ctypes.c_int
        lib.wsitile_read_region.argtypes = [ctypes.c_void_p, i64, i64,
                                            ctypes.c_int, i64, i64, p_u8]
        lib.wsitile_read_tiles.restype = ctypes.c_int
        lib.wsitile_read_tiles.argtypes = [ctypes.c_void_p, p_i64, p_i64,
                                           i64, ctypes.c_int, i64, i64,
                                           p_u8, ctypes.c_int]
        lib.wsitile_read_level.restype = ctypes.c_int
        lib.wsitile_read_level.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           p_u8, ctypes.c_int]
        lib.wsitile_write_raw.restype = ctypes.c_int
        lib.wsitile_write_raw.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          p_i64, p_i64,
                                          ctypes.POINTER(p_u8)]
        lib.wsitile_write_tiled.restype = ctypes.c_int
        lib.wsitile_write_tiled.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                            p_i64, p_i64,
                                            ctypes.POINTER(p_u8),
                                            ctypes.c_int]
        lib.wsitile_write_tiled_compressed.restype = ctypes.c_int
        lib.wsitile_write_tiled_compressed.argtypes = [
            ctypes.c_char_p, ctypes.c_int, p_i64, p_i64,
            ctypes.POINTER(p_u8), ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.wsitile_decode_failures.restype = i64
        lib.wsitile_decode_failures.argtypes = [ctypes.c_void_p]
        lib.wsitile_last_error.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeSlide:
    """First-party pyramidal slide reader (SlideReader protocol).

    ``read_region`` follows the OpenSlide convention used throughout the
    reference: level-0 coordinates, RGB output, white out-of-bounds
    (utils/dataset.py:175-178).
    """

    def __init__(self, path: str, default_threads: Optional[int] = None):
        self._lib = load_library()
        self._handle = self._lib.wsitile_open(path.encode())
        if not self._handle:
            err = self._lib.wsitile_last_error().decode()
            raise OSError(f"wsitile_open({path!r}) failed: {err}")
        self.path = path
        self._threads = default_threads or min(8, os.cpu_count() or 1)

        n = self._lib.wsitile_level_count(self._handle)
        dims = []
        for k in range(n):
            w, h = ctypes.c_int64(), ctypes.c_int64()
            self._lib.wsitile_level_dimensions(self._handle, k,
                                               ctypes.byref(w),
                                               ctypes.byref(h))
            dims.append((w.value, h.value))
        self._dims: Tuple[Tuple[int, int], ...] = tuple(dims)
        self._downsamples = tuple(
            self._lib.wsitile_level_downsample(self._handle, k)
            for k in range(n))

    # ---- SlideReader protocol ----

    @property
    def level_count(self) -> int:
        return len(self._dims)

    @property
    def level_dimensions(self) -> Tuple[Tuple[int, int], ...]:
        return self._dims

    @property
    def level_downsamples(self) -> Tuple[float, ...]:
        return self._downsamples

    def _raise(self, what: str):
        err = self._lib.wsitile_last_error().decode()
        nfail = self.decode_failures
        raise OSError(f"{what} failed on {self.path}: {err} "
                      f"(cumulative undecodable tiles: {nfail})")

    @property
    def decode_failures(self) -> int:
        """Cumulative count of undecodable tiles/strips on this handle.
        Nonzero means a read raised and white pixels were substituted —
        loud by design (the reference's OpenSlide would have decoded;
        silent white tiles corrupt downstream analysis)."""
        return int(self._lib.wsitile_decode_failures(self._handle))

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        w, h = int(size[0]), int(size[1])
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.wsitile_read_region(
            self._handle, int(location[0]), int(location[1]), level,
            w, h, _u8ptr(out))
        if rc != 0:
            self._raise("read_region")
        return out

    def read_level(self, level: int) -> np.ndarray:
        w, h = self._dims[level]
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.wsitile_read_level(self._handle, level, _u8ptr(out),
                                          self._threads)
        if rc != 0:
            self._raise("read_level")
        return out

    # ---- batched decode (the TPU input-pipeline hot path) ----

    def read_tiles(self, xs: Sequence[int], ys: Sequence[int], level: int,
                   tile_w: int, tile_h: int,
                   nthreads: Optional[int] = None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode n (tile_w × tile_h) tiles at LEVEL coordinates in
        parallel. Returns (n, tile_h, tile_w, 3) uint8 (``out`` reused when
        given — pass a pinned buffer for the device pipeline)."""
        xs_a = np.ascontiguousarray(xs, np.int64)
        ys_a = np.ascontiguousarray(ys, np.int64)
        n = len(xs_a)
        if out is None:
            out = np.empty((n, tile_h, tile_w, 3), np.uint8)
        rc = self._lib.wsitile_read_tiles(
            self._handle, _i64ptr(xs_a), _i64ptr(ys_a), n, level,
            tile_w, tile_h, _u8ptr(out), nthreads or self._threads)
        if rc != 0:
            self._raise("read_tiles")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.wsitile_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_tiled_pyramid(path: str, levels: Sequence[np.ndarray],
                        tile_size: int = 128,
                        compression: str = "none",
                        quality: int = 90) -> str:
    """Write a multi-directory TILED TIFF pyramid (the SVS-like layout).

    ``compression`` "jpeg" writes JPEG-compressed tiles (real Aperio JPEG
    SVS layout, TIFF compression 7); "none" writes raw tiles."""
    lib = load_library()
    arrs = [np.ascontiguousarray(lv, np.uint8) for lv in levels]
    ws = np.array([a.shape[1] for a in arrs], np.int64)
    hs = np.array([a.shape[0] for a in arrs], np.int64)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(arrs))(
        *[_u8ptr(a) for a in arrs])
    comp = {"none": 1, "jpeg": 7, "lzw": 5, "deflate": 8}[compression]
    rc = lib.wsitile_write_tiled_compressed(
        path.encode(), len(arrs), _i64ptr(ws), _i64ptr(hs), ptrs, tile_size,
        comp, quality)
    if rc != 0:
        err = lib.wsitile_last_error().decode()
        raise OSError(f"write_tiled_pyramid({path!r}) failed: {err}")
    return path


def write_raw_pyramid(path: str, levels: Sequence[np.ndarray]) -> str:
    """Write a ``.wsiraw`` pyramid from (H, W, 3) uint8 level arrays."""
    lib = load_library()
    arrs = [np.ascontiguousarray(lv, np.uint8) for lv in levels]
    ws = np.array([a.shape[1] for a in arrs], np.int64)
    hs = np.array([a.shape[0] for a in arrs], np.int64)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * len(arrs))(
        *[_u8ptr(a) for a in arrs])
    rc = lib.wsitile_write_raw(path.encode(), len(arrs), _i64ptr(ws),
                               _i64ptr(hs), ptrs)
    if rc != 0:
        raise OSError(f"write_raw_pyramid({path!r}) failed")
    return path
