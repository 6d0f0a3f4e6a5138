"""ctypes wrapper of the native batch cloud reader (the repository's
``csrc/fast_loader.cc``).

Port of ``patchaugnet_tpu/data/fast_loader.py``: one threaded C++ call
reads a batch of float64 ``.bin`` clouds and converts them to float32, in
place of a ``np.fromfile`` per file (utils/loading_pointclouds.py:14-48).
The library is built from that source with g++ at its first use, with
the JAX package's flags, into the port's build directory
(:mod:`..ops.cuda._host_build`). Where the build fails the call raises
with g++'s message; the JAX wrapper falls back to numpy without a word
instead. ``SceneDataset.native_loader = False`` chooses the numpy route.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from ..ops.cuda import _host_build

_FP = ctypes.POINTER(ctypes.c_float)


def _lib() -> ctypes.CDLL:
    lib = _host_build.load("fastloader")
    fn = lib.load_clouds_f64
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, _FP, _FP, ctypes.c_int,
                       ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (building it if needed)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def load_clouds(
    paths: Sequence[str],
    n_points: int,
    normalize: bool = False,
    n_threads: int = 8,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Batch-read float64 ``.bin`` clouds of ``n_points`` points.

    Returns ``(clouds (F, n_points, 3) float32,
    norm_meta (F, 4) [cx, cy, cz, scale], n_ok)``. A file that is missing
    or holds fewer than ``n_points`` points leaves a row of zeros (the
    reference's semantics, loading_pointclouds.py:26-30, with a line on
    stderr); one that holds more is read to its ``n_points``-th point.
    Raises ``RuntimeError`` if the library does not build.
    """
    lib = _lib()
    n = len(paths)
    out = np.zeros((n, n_points, 3), np.float32)
    meta = np.zeros((n, 4), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    n_ok = lib.load_clouds_f64(arr, n, int(n_points), out.ctypes.data_as(_FP), meta.ctypes.data_as(_FP),
                               int(normalize), int(n_threads))
    return out, meta, int(n_ok)
