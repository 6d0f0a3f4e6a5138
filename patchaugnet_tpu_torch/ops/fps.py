"""Farthest point sampling (kernel K1).

Port of ``patchaugnet_tpu/ops/fps.py``. The kernel replaces
``farthest_point_sample_pallas`` (``patchaugnet_tpu/ops/pallas/fps.py``,
``_fps_kernel``); the plain torch version is the counterpart of
``_farthest_point_sample_xla``. Semantics: the first index is 0; a
running per-point min-distance (init 1e10) is lowered by the squared
distance to each new pick; the next pick is its arg-max, the lowest index
on ties.

The kernel (``csrc/fps.cu``) is bound by latency on the H100: m - 1
dependent steps, each an O(n) update and a block-wide arg-max. One block
of T threads takes a cloud, each thread keeping PPT points and their
min-distances in registers; :func:`layout_for` picks (T, PPT) per level,
and a tensor on the card runs the kernel, with no plain fallback. Both
devices reach it through the operator ``torch.ops.pan.fps``
(``ops/library.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import contracts
from .cuda import launch
from .library import LIB

# kernel launches so far; chip_smoke.py resets and reads it
launches = 0

# (threads per cloud, points per thread): the layouts the kernel is built
# for (csrc/fps.cu), which are those layout_for picks; SCRATCH keeps the
# min-distances in a global row and takes any n
SCRATCH = (1024, 0)
LAYOUTS = ((32, 1), (32, 2), (32, 4), (32, 8), (512, 1), (1024, 1), (256, 8), (512, 8), (1024, 8), SCRATCH)
WARP_MAX_PPT = 8        # one warp holds up to 32 * 8 points
_ONE_POINT_MAX = 1024   # up to here one point per thread
_PPT = 8                # beyond, 8 points per thread
_MAX_REGISTER_POINTS = 1024 * _PPT


def layout_for(n: int) -> Tuple[int, int]:
    """(threads per cloud, points per thread) for clouds of ``n`` points.

    From K1's device time at every layout on an H100
    (``profile_torch.py --kernels --layouts``, PERF.md): a cloud of up to
    256 points runs on one warp, which needs no block barrier; up to 1024
    points one point per thread (512 or 1024 threads); larger clouds 8
    points per thread on the fewest threads that hold them (256, 512 or
    1024), where more points per thread put more of each step into the
    update and fewer into the barrier and the arg-max over the warps;
    beyond 8192 points the scratch path. The same layout was fastest at
    B=32 and B=100, so the batch does not enter.
    """
    if n > _MAX_REGISTER_POINTS:
        return SCRATCH
    if n <= 32 * WARP_MAX_PPT:
        return 32, _ceil_pow2(-(-n // 32))
    if n <= _ONE_POINT_MAX:
        return _ceil_pow2(n), 1
    return _ceil_pow2(-(-n // _PPT)), _PPT


def _ceil_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def farthest_point_sample(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """Sample ``m`` of ``n`` points maximising pairwise min-distance.

    Args:
      xyz: ``(b, n, 3)`` float coordinates.
      m: number of samples; ``m > n`` is allowed (indices repeat).

    Returns:
      ``(b, m)`` int32 indices into ``xyz``, by ``torch.ops.pan.fps``: a
      CUDA tensor runs the kernel, a CPU tensor the plain torch version.
    """
    contracts.check_points(xyz, "xyz")
    if m <= 0:
        raise ValueError(f"m={m} must be positive")
    if contracts.check_device(xyz, "xyz") == "cuda":
        return _fps_cuda(xyz, m)
    return torch.ops.pan.fps(xyz, m, 0, 0)


def _fps_cuda(xyz: torch.Tensor, m: int, layout: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The kernel at the layout :func:`layout_for` picks, or at ``layout``
    (tests and tuning)."""
    threads, ppt = layout_for(xyz.shape[1]) if layout is None else layout
    return torch.ops.pan.fps(xyz, m, threads, ppt)


def _fps_kernel(xyz: torch.Tensor, m: int, threads: int, ppt: int) -> torch.Tensor:
    """``pan::fps`` for CUDA: one launch of the kernel, counted in ``launches``."""
    global launches
    b, n, _ = xyz.shape
    if n == 0 or n >= 2**31 // 3:
        raise ValueError(f"xyz {tuple(xyz.shape)}: the CUDA FPS kernel takes 0 < n < 2**31 / 3")
    if (threads, ppt) not in LAYOUTS or 0 < threads * ppt < n:
        raise ValueError(f"layout={(threads, ppt)}: the CUDA FPS kernel is built for {LAYOUTS} "
                         f"(threads * points per thread >= n, or {SCRATCH}), at n={n}")
    if m == 1 or b == 0:
        return torch.zeros((b, m), dtype=torch.int32, device=xyz.device)
    xyz = xyz.to(torch.float32).contiguous()
    idx = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device) if ppt == 0 else None
    launch("fps", "pan_fps", xyz.device, xyz, scratch, idx, b, n, m, threads, ppt)
    launches += 1
    return idx


def _fps_plain(xyz: torch.Tensor, m: int, threads: int, ppt: int) -> torch.Tensor:
    """``pan::fps`` for the CPU: the plain version (the layout is the card's)."""
    return _farthest_point_sample_torch(xyz, m)


def _fps_fake(xyz: torch.Tensor, m: int, threads: int, ppt: int) -> torch.Tensor:
    return xyz.new_empty((xyz.shape[0], m), dtype=torch.int32)


def _farthest_point_sample_torch(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version: one vectorised distance update and ``torch.argmax``
    (first maximum) per step, distances summed as ((0 + dx^2) + dy^2) + dz^2."""
    b, n, _ = xyz.shape
    xyz = xyz.to(torch.float32)
    idx = torch.zeros((b, m), dtype=torch.int32, device=xyz.device)
    min_d = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, m):
        pt = xyz[rows, last]                                # (b, 3)
        d = torch.zeros((b, n), dtype=torch.float32, device=xyz.device)
        for c in range(3):
            diff = xyz[:, :, c] - pt[:, None, c]
            d = d + diff * diff
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        idx[:, i] = last.to(torch.int32)
    return idx


LIB.impl("fps", _fps_kernel, "CUDA")
LIB.impl("fps", _fps_plain, "CPU")
torch.library.register_fake("pan::fps", _fps_fake, lib=LIB)
