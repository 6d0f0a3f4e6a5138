"""Build the port's CUDA kernels with nvcc and call them through ctypes.

Each ``patchaugnet_tpu_torch/csrc/<name>.cu`` compiles on its own into a
shared library with a plain C interface, at first use, into
``build/patchaugnet_tpu_torch/`` at the root of the checkout. A library's
file name carries a hash of its sources and of the nvcc flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
:func:`build` starts one nvcc for each library that is missing, all at
once, and waits for all of them; a library loaded before it is built is
built at that point, with the other missing ones of :data:`FORWARD`. No
source includes PyTorch's headers: an nvcc run takes seconds, where a
PyTorch extension build takes minutes.

Every C entry point takes its device pointers as ``void*``, its sizes as
``int``/``long long`` and PyTorch's current stream last, enqueues its
kernel without synchronising, and returns ``cudaGetLastError()``;
:func:`launch` raises if that is not ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "patchaugnet_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# library name -> {C entry point: argument types, the stream included}
LIBRARIES: Dict[str, Dict[str, list]] = {
    "fps": {"pan_fps": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
            "pan_fps_step_floor": [_P, _I, _I, _I, _P]},
    "knn": {"pan_knn": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "topk": {"pan_topk_extract": [_P, _P, _P, _L, _I, _I, _I, _P],
             "pan_topk_extract_price": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
             "pan_topk_extract_price_rows": [_P, _P, _P, _L, _P, _P, _L, _I, _I, _I, _I, _I, _P]},
    "bn_relu": {"pan_bn_relu": [_P, _P, _P, _P, _P, _L, _I, _I, _P]},
}

# the libraries an eval forward or a train step loads: the first one missing
# builds every missing one of them, in one batch of nvcc processes (about
# 5 s on an H100 host). topk stays out: its nvcc alone takes about 50 s,
# and neither path loads it (the auction EMD does).
FORWARD = ("fps", "knn", "bn_relu")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# (library, C entry point) -> the bound function, resolved at its first launch
_entry_points: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc`` as PyTorch finds it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc process each, all started together. Returns each library's
    nvcc output (ptxas register, shared-memory and spill report)."""
    names = list(LIBRARIES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = {}
    for name in names:
        log = _library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build(FORWARD if name in FORWARD else [name])
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in LIBRARIES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pan_error_string.argtypes = [ctypes.c_int]
            lib.pan_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call ``fn_name`` of library ``name`` on ``device``'s current stream.

    Tensors pass as their data pointers and ``None`` as a null pointer;
    the caller holds the tensors (and so keeps the memory alive) until the
    kernel has run on the stream. The device is entered only when it is
    not the current one.
    """
    fn = _entry_points.get((name, fn_name))
    if fn is None:
        fn = _entry_points[(name, fn_name)] = getattr(_library(name), fn_name)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the raw stream handle, read as Triton's launcher reads it (no Stream object)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*c_args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*c_args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        msg = _library(name).pan_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")


def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device`` (the current CUDA device where it
    has no index), the input of the kernels' launch-shape rules."""
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
