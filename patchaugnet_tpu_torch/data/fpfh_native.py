"""ctypes wrapper of the native FPFH (the repository's ``csrc/fpfh.cc``).

Port of ``patchaugnet_tpu/data/fpfh_native.py``. The C++ source computes
the formulation of :mod:`.fpfh` (the same neighbourhoods, normals,
binning and weighting; the contract is ``csrc/fpfh.cc``'s header comment)
with per-point threads. The library is built from that source with g++
at its first use, with the JAX package's flags, into the port's build
directory (:mod:`..ops.cuda._host_build`). Where the build fails the
call raises with g++'s message; the JAX wrapper falls back to numpy
without a word instead. ``PCR_FPFH_NATIVE=0`` or
``compute_fpfh(..., use_native=False)`` chooses the numpy route.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops.cuda import _host_build

_DP = ctypes.POINTER(ctypes.c_double)


def _lib() -> ctypes.CDLL:
    lib = _host_build.load("fpfh")
    fn = lib.compute_fpfh_f64
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_DP, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
                       _DP, _DP, _DP, ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (building it if needed)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def compute_fpfh_native(
    points: np.ndarray,
    radius_normal: float,
    radius_feature: float,
    max_nn_normal: int,
    max_nn_feature: int,
    normals: Optional[np.ndarray] = None,
    return_normals: bool = False,
    n_threads: int = 0,
):
    """``(N, 3) -> (N, 33)`` float64 FPFH via the C++ path (with
    ``return_normals``, also the ``(N, 3)`` normals it used). ``n_threads``
    0 takes every core. Raises ``RuntimeError`` if the library does not
    build."""
    lib = _lib()
    pts = np.ascontiguousarray(np.asarray(points, np.float64))
    n = pts.shape[0]
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {pts.shape}")
    out = np.zeros((n, 33), np.float64)
    norm_out = np.zeros((n, 3), np.float64) if return_normals else None
    if n == 0:
        return (out, norm_out) if return_normals else out
    nin = None
    if normals is not None:
        nin = np.ascontiguousarray(np.asarray(normals, np.float64))
        if nin.shape != (n, 3):
            raise ValueError(f"normals must be ({n}, 3), got {nin.shape}")
    rc = lib.compute_fpfh_f64(
        pts.ctypes.data_as(_DP), n,
        float(radius_normal), float(radius_feature),
        int(max_nn_normal), int(max_nn_feature),
        nin.ctypes.data_as(_DP) if nin is not None else None,
        out.ctypes.data_as(_DP),
        norm_out.ctypes.data_as(_DP) if norm_out is not None else None,
        int(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"compute_fpfh_f64 failed (rc={rc})")
    return (out, norm_out) if return_normals else out
