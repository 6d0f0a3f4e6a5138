"""k-nearest-neighbour and ball queries on fixed-shape point sets (kernel K2).

Port of ``patchaugnet_tpu/ops/knn.py``: ``knn``, ``dilated_knn``,
``knn_exclude_self`` (K2 at k + 1) and ``ball_query`` (plain torch ops, no
kernel, as in the JAX package, where XLA forms it).
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
per 65535. Both devices reach it through the operator
``torch.ops.pan.knn`` (``ops/library.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import contracts
from .cuda import launch, sm_count
from .library import LIB
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
      approx_recall: the recall target of the JAX package's approximate
        top-k (``lax.approx_max_k``, ``KNN_APPROX_RECALL``), in (0, 1].
        That top-k is approximate on the TPU only: XLA lowers it to the
        exact top-k on every other backend, so here, as there, the target
        is checked and the exact kNN runs.

    Returns:
      ``(idx, sqdist)``: ``(b, m, k)`` int32 indices sorted by ascending
      distance, and the matching squared distances.

    3-d points go through ``torch.ops.pan.knn``: a CUDA tensor runs the
    kernel at any shape, a CPU tensor the plain version. Points of another
    width take the split path.
    """
    contracts.check_features(xyz, "xyz")
    if new_xyz is None:
        new_xyz = xyz
    contracts.check_features(new_xyz, "new_xyz")
    contracts.check_same_batch(xyz, new_xyz, "xyz", "new_xyz")
    contracts.check_k(k, xyz.shape[-2])
    if approx_recall is not None and not 0.0 < approx_recall <= 1.0:
        raise ValueError(f"approx_recall={approx_recall}: a recall target lies in (0, 1]")
    if xyz.shape[-1] != 3:
        return topk_extract(pairwise_sqdist(new_xyz, xyz), k)
    if contracts.check_device(xyz, "xyz") == "cuda":
        return _knn_cuda(xyz, new_xyz, k)
    return torch.ops.pan.knn(xyz, new_xyz, k, 0)


def _knn_cuda(
    xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, lanes: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel at the lanes :func:`lanes_for` picks for this card, or
    at ``lanes`` (tests and tuning)."""
    if lanes is None:
        b, n, _ = xyz.shape
        lanes = lanes_for(b, n, new_xyz.shape[1], k, sm_count(xyz.device))
    return torch.ops.pan.knn(xyz, new_xyz, k, lanes)


def _knn_kernel(
    xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, lanes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pan::knn`` for CUDA: one launch of the kernel, counted in ``launches``."""
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
    if lanes not in LANES or (-(-k // lanes) > _MAX_SLOTS and lanes != LANES[-1]):
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


def _knn_plain(
    xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, lanes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pan::knn`` for the CPU: the plain version (the lanes are the card's)."""
    return _knn_torch(xyz, new_xyz, k)


def _knn_fake(
    xyz: torch.Tensor, new_xyz: torch.Tensor, k: int, lanes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (xyz.shape[0], new_xyz.shape[1], k)
    return xyz.new_empty(shape, dtype=torch.int32), xyz.new_empty(shape, dtype=torch.float32)


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
    approx_recall: Optional[float] = None,
) -> torch.Tensor:
    """Dilated kNN exactly as the reference's ``QueryAndGroup_Edge``.

    The reference queries ``dilation * k`` candidates and indexes the
    first k of them with a random permutation of ``range(k)``: the first
    k of the sorted dilated candidates are the plain k nearest, so only k
    neighbours are extracted. Consumers are permutation invariant, so the
    shuffle runs only when a ``generator`` is given (the eval path passes
    none). ``approx_recall`` as :func:`knn`.
    """
    idx, _ = knn(xyz, new_xyz, k, approx_recall)
    if dilation > 1 and generator is not None:
        perm = torch.randperm(k, generator=generator, device=generator.device)
        idx = idx[..., perm.to(idx.device)]
    return idx


def ball_query(radius: float, k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """Fixed-size radius query with the reference's padding semantics
    (``ballquery_cuda_kernel.cu:6-60``): the first ``k`` points within
    ``radius`` of each query in index order, the trailing slots padded with
    the first in-radius index, zeros where no point is in the ball.

    Membership is ``pairwise_sqdist < radius * radius`` (the square rounded
    to f32, as JAX rounds its weak-typed constant), on the direct-difference
    form at d <= 4, the bits of the JAX version. The first k in-ball indices
    are the top k of an int32 score (``-index`` in the ball, INT32_MIN out),
    as ``lax.top_k`` takes them. Forms the ``(b, m, n)`` distances and the
    score: 512 MiB each at b=32, m=1024, n=4096.

    Returns ``(b, m, k)`` int32 indices.
    """
    contracts.check_features(xyz, "xyz")
    contracts.check_features(new_xyz, "new_xyz")
    contracts.check_same_batch(xyz, new_xyz, "xyz", "new_xyz")
    contracts.check_k(k, xyz.shape[-2])
    d = pairwise_sqdist(new_xyz, xyz)                      # (b, m, n)
    in_ball = d < torch.full((), radius * radius, dtype=d.dtype, device=d.device)
    empty = torch.iinfo(torch.int32).min
    iota = torch.arange(xyz.shape[-2], dtype=torch.int32, device=d.device)
    score = torch.where(in_ball, -iota, empty)
    top = torch.topk(score, k, dim=-1).values              # (b, m, k), descending
    valid = top != empty
    idx = torch.where(valid, -top, 0)
    idx = torch.where(valid, idx, idx[..., :1])            # pad with the first in-radius index
    return torch.where(valid[..., :1], idx, 0)             # no neighbour at all: zeros


def knn_exclude_self(xyz: torch.Tensor, new_xyz: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """kNN without the closest match (reference ``KNNQueryExclude``,
    ``pointops.py:436-473``): ranks ``1..k`` of :func:`knn` at ``k + 1``,
    one K2 launch on the card. On duplicate points rank 0 is the lowest
    index among the tied, which need not be the query itself."""
    idx, _ = knn(xyz, new_xyz, k + 1)
    return idx[..., 1:]


LIB.impl("knn", _knn_kernel, "CUDA")
LIB.impl("knn", _knn_plain, "CPU")
torch.library.register_fake("pan::knn", _knn_fake, lib=LIB)
