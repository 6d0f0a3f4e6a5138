"""Build the host libraries of the repository's root ``csrc/`` with g++.

``csrc/fpfh.cc`` (FPFH features, :mod:`..data.fpfh_native`) and
``csrc/fast_loader.cc`` (the batch cloud reader, :mod:`..data.fast_loader`)
are the JAX package's C++ sources, built here with the JAX package's
flags. Each library is compiled at first use into the directory that
holds the CUDA kernels (:data:`._build.BUILD_DIR`, never into ``csrc/``),
under a file name that carries a hash of its source and its flags, so an
edited source is rebuilt and an unchanged one loaded as it is. A build
holds an exclusive lock on a file beside it while it compiles (processes
that want the same library wait, then load what the first one built) and
writes to a temporary name that it renames into place, so no process
loads a half-written library.

A build that fails raises ``RuntimeError`` with g++'s own message: no
caller falls back to a numpy route that it did not ask for.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

from ._build import BUILD_DIR

CSRC_DIR = Path(__file__).resolve().parents[3] / "csrc"

# library -> (source in csrc/, g++ flags): the JAX package's
# (patchaugnet_tpu/data/fpfh_native.py, fast_loader.py)
LIBRARIES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "fpfh": ("fpfh.cc", ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17", "-pthread")),
    "fastloader": ("fast_loader.cc", ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    source, flags = LIBRARIES[name]
    h = hashlib.sha256()
    h.update((CSRC_DIR / source).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless it is built; returns its path."""
    out = library_path(name)
    if out.exists():
        return out
    source, flags = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():                                  # built while this process waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *flags, str(CSRC_DIR / source), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError(f"building {source} needs g++, which is not on PATH") from None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {source} (exit {proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Library ``name``, built at its first use in this process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
