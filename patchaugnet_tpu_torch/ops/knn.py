"""k-nearest-neighbour queries on fixed-shape point sets (kernel K2).

Port of ``knn`` and ``dilated_knn`` of ``patchaugnet_tpu/ops/knn.py``.
The kernel replaces ``knn_fused_pallas`` (``patchaugnet_tpu/ops/pallas/
knn.py``, ``_fused_knn_kernel`` + ``_extract_sweeps``): exact kNN of 3-d
points with the squared distances formed in the kernel, ascending, the
lowest candidate index on ties. Points of another width take the split
path of ``knn_pallas``: ``pairwise_sqdist`` and the top-k extraction
(kernel K3 on the card).

The kernel (``csrc/knn.cu``) is bound by f32 operations on the H100 (a
distance and a compare per pair against a few MB of input). G lanes take
a query (:func:`lanes_for` picks G per shape), candidates stream through
shared memory, and the G lanes keep one sorted list of the query's best
pairs between them, whose k-th entry rejects candidates for all of them.
The list holds 96 pairs at the most; a larger k runs in passes of 96
inside the kernel, and a batch of more than 65535 clouds in one launch
per 65535.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import contracts
from .cuda import launch, sm_count
from .pairwise import pairwise_sqdist
from .topk import _topk_extract_torch, topk_extract

# kernel launches so far; chip_smoke.py resets and reads it
launches = 0

# the kernel's lanes per query (G), and the targets of :func:`lanes_for`
LANES = (4, 8, 16, 32)
_MAX_SLOTS = 3         # list slots per lane, ceil(k / G), at the most (csrc/knn.cu's kMaxSlots)
_WARPS_PER_SM = 16     # resident warps per SM that hide the scan's latency
_MIN_SCAN = 2          # candidates per lane at the least


def lanes_for(b: int, n: int, m: int, k: int, sms: int) -> int:
    """Lanes per query for a ``(b, n, m, k)`` launch on a card of ``sms``
    SMs: the fewest that keep each lane's share of the list at
    ``_MAX_SLOTS`` slots or fewer (an insertion costs every lane its
    slots), doubled while the card holds fewer than ``_WARPS_PER_SM``
    warps per SM and each lane keeps ``_MIN_SCAN`` candidates or more.
    A k past ``32 * _MAX_SLOTS`` takes 32 lanes, and the kernel runs it in
    passes.

    On an H100 this picks 8 lanes at k=20 over 4096 candidates and 4 at
    k=3 over 1024 (the first SA and FP levels at B=32), and more lanes at
    the small levels, where 4 leave most of the card idle (PERF.md).
    """
    g = next((g for g in LANES if -(-k // g) <= _MAX_SLOTS), LANES[-1])
    while (g < LANES[-1] and b * m * g < 32 * _WARPS_PER_SM * sms
           and n >= _MIN_SCAN * 2 * g):
        g *= 2
    return g


def knn(
    xyz: torch.Tensor,
    new_xyz: Optional[torch.Tensor],
    k: int,
    approx_recall: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``new_xyz`` among ``xyz``.

    Args:
      xyz: ``(b, n, d)`` reference points.
      new_xyz: ``(b, m, d)`` query points (``None`` -> ``xyz``).
      k: number of neighbours.
      approx_recall: the JAX package's approximate TPU top-k; it has no
        GPU counterpart yet and raises ``NotImplementedError``.

    Returns:
      ``(idx, sqdist)``: ``(b, m, k)`` int32 indices sorted by ascending
      distance, and the matching squared distances.

    A CPU tensor runs the plain version. A CUDA tensor of 3-d points runs
    the kernel at any shape; points of another width take the split path.
    """
    contracts.check_features(xyz, "xyz")
    if new_xyz is None:
        new_xyz = xyz
    contracts.check_features(new_xyz, "new_xyz")
    contracts.check_same_batch(xyz, new_xyz, "xyz", "new_xyz")
    contracts.check_k(k, xyz.shape[-2])
    if approx_recall is not None:
        raise NotImplementedError("approximate kNN (lax.approx_max_k) is not ported")
    if contracts.check_device(xyz, "xyz") == "cuda" and xyz.shape[-1] == 3:
        return _knn_cuda(xyz, new_xyz, k)
    return topk_extract(pairwise_sqdist(new_xyz, xyz), k)


def _knn_cuda(
    xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, lanes: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel; ``lanes`` overrides :func:`lanes_for` (tests and tuning)."""
    global launches
    if new_xyz.shape[-1] != 3:
        raise ValueError(f"new_xyz: expected (B, M, 3), got {tuple(new_xyz.shape)}")
    if new_xyz.device != xyz.device:
        raise ValueError(f"new_xyz on {new_xyz.device}, xyz on {xyz.device}")
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if not 1 <= k <= n or n >= 2**31 // 3:
        raise ValueError(f"xyz {tuple(xyz.shape)}, k={k}: the CUDA kNN kernel takes 1 <= k <= n "
                         f"and n < 2**31 / 3")
    if lanes is None:
        lanes = lanes_for(b, n, m, k, sm_count(xyz.device))
    elif lanes not in LANES or (-(-k // lanes) > _MAX_SLOTS and lanes != LANES[-1]):
        raise ValueError(f"lanes={lanes}: the CUDA kNN kernel takes {LANES} with at most "
                         f"{_MAX_SLOTS} list slots per lane, ceil(k / lanes), at k={k}, "
                         f"or {LANES[-1]} at any k")
    xyz = xyz.to(torch.float32).contiguous()
    new_xyz = new_xyz.to(torch.float32).contiguous()
    idx = torch.empty((b, m, k), dtype=torch.int32, device=xyz.device)
    d2 = torch.empty((b, m, k), dtype=torch.float32, device=xyz.device)
    if b * m == 0:
        return idx, d2
    launch("knn", "pan_knn", xyz.device, xyz, new_xyz, idx, d2, b, n, m, k, lanes)
    launches += 1
    return idx, d2


def _knn_torch(xyz: torch.Tensor, new_xyz: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the full distance matrix, then k
    arg-min sweeps."""
    return _topk_extract_torch(pairwise_sqdist(new_xyz, xyz), k)


def dilated_knn(
    xyz: torch.Tensor,
    new_xyz: Optional[torch.Tensor],
    k: int,
    dilation: int = 1,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dilated kNN exactly as the reference's ``QueryAndGroup_Edge``.

    The reference queries ``dilation * k`` candidates and indexes the
    first k of them with a random permutation of ``range(k)``: the first
    k of the sorted dilated candidates are the plain k nearest, so only k
    neighbours are extracted. Consumers are permutation invariant, so the
    shuffle runs only when a ``generator`` is given (the eval path passes
    none).
    """
    idx, _ = knn(xyz, new_xyz, k)
    if dilation > 1 and generator is not None:
        perm = torch.randperm(k, generator=generator, device=generator.device)
        idx = idx[..., perm.to(idx.device)]
    return idx
