"""ctypes loader for the native chip set-cover kernel (native/chips.cpp).

A jax-free copy of sniper_tpu/chips/_native.py: it loads the same
native/libsniper_chips.so, and returns None when the library is not
built (the chip generator then uses its NumPy set-cover).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

# default: repo-checkout layout (<repo>/native/, built by
# scripts/build_native.sh); a pip-installed package points at its build
# via SNIPER_TPU_CHIPS_SO
_SO = os.environ.get("SNIPER_TPU_CHIPS_SO") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libsniper_chips.so",
)


class _CppCover:
    def __init__(self, lib):
        self._fn = lib.sniper_greedy_cover
        self._fn.restype = ctypes.c_int
        self._fn.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]

    def greedy_cover(self, cands: np.ndarray, boxes: np.ndarray) -> list[int]:
        cands = np.ascontiguousarray(cands, dtype=np.float64)
        boxes = np.ascontiguousarray(boxes, dtype=np.float64)
        out = np.empty(cands.shape[0], dtype=np.int32)
        n = self._fn(
            cands.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cands.shape[0],
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            boxes.shape[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return out[:n].tolist()


_CACHED: list = []  # [handle-or-None]; dlopen once per process


def load() -> _CppCover | None:
    """Load the native kernel; None when not built (NumPy fallback used).

    Cached at module level: the per-epoch re-roll builds a
    ChipGenerator per image, and an uncached load() would re-stat +
    re-dlopen the .so once per image per epoch (100k syscalls/epoch at
    dataset scale).
    """
    # only SUCCESSFUL loads are pinned: a None (missing/broken .so) is
    # re-tried on the next call, so building libsniper_chips.so mid-
    # process picks up the native kernel instead of silently keeping
    # the NumPy fallback for the process lifetime. The re-try is one
    # os.path.exists stat — cheap even per-image.
    if not _CACHED or _CACHED[0] is None:
        handle = None
        if os.path.exists(_SO):
            try:
                handle = _CppCover(ctypes.CDLL(_SO))
            except OSError:
                handle = None
        _CACHED.clear()
        _CACHED.append(handle)
    return _CACHED[0]
