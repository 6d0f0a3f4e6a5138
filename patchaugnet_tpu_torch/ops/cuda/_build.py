"""Build the port's CUDA kernels with nvcc and call them through ctypes.

Each ``patchaugnet_tpu_torch/csrc/<name>.cu`` compiles on its own into a
shared library with a plain C interface, at first use, into
``build/patchaugnet_tpu_torch/`` at the root of the checkout. A library's
file name carries a hash of its sources and of the nvcc flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
:func:`build` starts one nvcc for each library that is missing, all at
once, and waits for all of them. No source includes PyTorch's headers:
an nvcc run takes seconds, where a PyTorch extension build takes minutes.

Every C entry point takes its device pointers as ``void*``, its sizes as
``int``/``long long`` and PyTorch's current stream last, enqueues its
kernel without synchronising, and returns ``cudaGetLastError()``;
:func:`launch` raises if that is not ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

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
    "fps": {"pan_fps": [_P, _P, _P, _I, _I, _I, _P]},
    "knn": {"pan_knn": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "topk": {"pan_topk_extract": [_P, _P, _P, _L, _I, _I, _P],
             "pan_topk_extract_price": [_P, _P, _P, _P, _L, _I, _I, _I, _P]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


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
                build([name])
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

    Tensors pass as their data pointers; the caller holds them (and so
    keeps the memory alive) until the kernel has run on the stream.
    """
    lib = _library(name)
    fn = getattr(lib, fn_name)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*c_args, stream)
    if err != 0:
        msg = lib.pan_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")
