"""ctypes bindings for the native C++ data loader (``native/loader.cpp``).

The port's own copy of ``instantir_tpu/data/native_loader.py``, with the same
API: libjpeg/libpng decode + bilinear shorter-side resize + seeded random
crop, and a background prefetch thread so that image IO overlaps device
compute. When the shared library has not been built (``native/build.sh``),
``available()`` is False and ``decode_crop`` / ``probe`` return None: host
data loading then takes the Pillow path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "native", "libitir_loader.so")
_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.itir_decode_crop.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                                     ctypes.POINTER(ctypes.c_uint8)]
    lib.itir_decode_crop.restype = ctypes.c_int
    lib.itir_probe.argtypes = [ctypes.c_char_p]
    lib.itir_probe.restype = ctypes.c_uint64
    lib.itir_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.itir_loader_create.restype = ctypes.c_void_p
    lib.itir_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.itir_loader_next.restype = ctypes.c_int
    lib.itir_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def decode_crop(path: str, size: int, seed: int = 0) -> Optional[np.ndarray]:
    """Decode + shorter-side resize + seeded random crop -> [size, size, 3] uint8 (None on failure)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.itir_decode_crop(path.encode(), size, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def probe(path: str) -> Optional[tuple]:
    """(width, height) of an image file from its header, or None."""
    lib = _load()
    if lib is None:
        return None
    v = lib.itir_probe(path.encode())
    if v == 0:
        return None
    return (v >> 32, v & 0xFFFFFFFF)


class NativePrefetchLoader:
    """Background-thread batch producer over a weighted file list: ``next()``
    gives ``[batch, gt_size, gt_size, 3]`` uint8 (a file that fails to decode
    gives a gray crop)."""

    def __init__(self, files: Sequence[str], weights: Optional[Sequence[float]], gt_size: int,
                 batch: int, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader not built; run native/build.sh")
        self.gt_size, self.batch = gt_size, batch
        self._paths = [f.encode() for f in files]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        warr = None
        if weights is not None:
            warr = (ctypes.c_double * len(files))(*[float(w) for w in weights])
        self._handle = lib.itir_loader_create(arr, warr, len(files), gt_size, batch, seed)
        self._lib = lib

    def next(self) -> np.ndarray:
        out = np.empty((self.batch, self.gt_size, self.gt_size, 3), np.uint8)
        rc = self._lib.itir_loader_next(self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise RuntimeError("native loader stopped")
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def close(self):
        if self._handle:
            self._lib.itir_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
