"""Point ops over clouds whose point axis is split across ranks.

Port of ``patchaugnet_tpu/parallel/sharded_ops.py``. Each rank holds its
contiguous shard of the point axis, ``(b, n / size, 3)``, where ``size``
is the mesh's size along ``axis_name``; queries and index tables are
replicated along it. The results equal the single-device ops exactly:

  - :func:`sharded_knn`: the kNN kernel (K2) on each rank's shard at
    ``min(k, shard_n)``, the candidate lists gathered along the axis, and
    a stable sort by distance merges them: shards lie in index order and
    each list is sorted with the lowest index first on ties, so the merge
    gives the single-device order, ties to the lowest index;
  - :func:`sharded_fps`: each rank keeps the running min-distances of its
    shard; per pick one collective exchanges each rank's champion (its
    largest min-distance, the point's global index and coordinates), and
    every rank takes the largest, ties to the lowest rank (= the lowest
    index). That is ``m`` collectives per call;
  - :func:`sharded_gather`: each global row comes from its owner, the
    other ranks add exact zeros (one ``all_reduce``).

On a 2-D mesh (the JAX ``("data", "points")`` form) the inputs are this
rank's rows of the batch, and every collective runs within the
``axis_name`` sub-group (``Mesh.group``), so the batch axis needs no
argument.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .. import ops
from ..nn.core import group_sum
from .mesh import Mesh, gather_rows

__all__ = [
    "sharded_knn",
    "sharded_fps",
    "sharded_topk_neighbors",
    "sharded_gather",
    "sharded_group",
    "sharded_sa_level",
]


def _offset(mesh: Mesh, axis_name: str, shard_n: int) -> int:
    return mesh.index(axis_name) * shard_n


def sharded_knn(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    k: int,
    mesh: Mesh,
    axis_name: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the reference points split along ``axis_name``.

    Args:
      xyz: ``(b, shard_n, d)``: this rank's shard of the ``(b, n, d)``
        points.
      new_xyz: ``(b, m, d)`` queries, the same on every rank of the axis.
    Returns ``(idx, d2)`` ``(b, m, k)``, int32 global indices and squared
    distances, equal to ``ops.knn`` on the whole cloud, on every rank of
    the axis.
    """
    shard_n = xyz.shape[1]
    n = shard_n * mesh.shape[axis_name]
    if not 1 <= k <= n:
        raise ValueError(f"k={k}: expected 1 <= k <= n={n}")
    idx_l, d_l = ops.knn(xyz, new_xyz, min(k, shard_n))
    idx_g = idx_l.to(torch.int64) + _offset(mesh, axis_name, shard_n)
    d_all = gather_rows(d_l, mesh, axis_name, dim=-1)
    idx_all = gather_rows(idx_g, mesh, axis_name, dim=-1)
    d_sorted, order = torch.sort(d_all, dim=-1, stable=True)
    return idx_all.gather(-1, order[..., :k]).to(torch.int32), d_sorted[..., :k]


def sharded_topk_neighbors(
    queries: torch.Tensor,
    database: torch.Tensor,
    k: int,
    mesh: Mesh,
    axis_name: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descriptor retrieval with the database's rows split along
    ``axis_name``: ``queries`` ``(q, d)`` on every rank, ``database`` this
    rank's ``(m / size, d)`` rows. Returns ``(d2, idx)`` ``(q, k)``,
    ascending, the lowest index on ties, equal to
    ``data.retrieval.topk_neighbors`` on the whole database."""
    idx, d2 = sharded_knn(database[None], queries[None], k, mesh, axis_name=axis_name)
    return d2[0], idx[0]


def sharded_gather(
    features: torch.Tensor,
    idx: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "data",
) -> torch.Tensor:
    """``out[b, j, c] = features[b, idx[b, j], c]`` by global index from a
    table whose ``n`` axis is split along ``axis_name``: ``features`` is
    this rank's ``(b, shard_n, c)`` shard, ``idx`` ``(b, m)`` global
    indices on every rank of the axis. Each row comes from its owner and
    the others add exact zeros, so the result is ``ops.gather``'s bits, on
    every rank of the axis. Carries autograd."""
    shard_n = features.shape[1]
    offset = _offset(mesh, axis_name, shard_n)
    loc = idx.to(torch.int64) - offset
    owned = (loc >= 0) & (loc < shard_n)
    g = ops.gather(features, loc.clamp(0, shard_n - 1))
    g = torch.where(owned[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    return group_sum(g, mesh.group(axis_name))


def sharded_group(
    features: torch.Tensor,
    idx: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "data",
) -> torch.Tensor:
    """``out[b, j, s, c] = features[b, idx[b, j, s], c]``: the grouped form
    of :func:`sharded_gather` (``idx`` ``(b, m, k)``)."""
    b, m, k = idx.shape
    flat = sharded_gather(features, idx.reshape(b, m * k), mesh, axis_name)
    return flat.reshape(b, m, k, features.shape[-1])


def sharded_fps(
    xyz: torch.Tensor,
    m: int,
    mesh: Mesh,
    axis_name: str = "data",
) -> torch.Tensor:
    """Exact FPS with the point axis split along ``axis_name``: ``xyz`` is
    this rank's ``(b, shard_n, 3)`` shard. Returns ``(b, m)`` int32 global
    indices equal to ``ops.farthest_point_sample`` on the whole cloud (the
    first index 0, the lowest index on ties), on every rank of the axis.

    The distances are summed as the plain FPS and the kernel K1 sum them,
    ((0 + dx^2) + dy^2) + dz^2. Each pick is one collective of every rank's
    champion: the value, the global index and the coordinates, packed in
    f32 (indices below 2^24 are exact)."""
    b, shard_n, _ = xyz.shape
    if shard_n * mesh.shape[axis_name] >= 2 ** 24:
        raise ValueError(f"sharded_fps takes fewer than 2**24 points, got {shard_n * mesh.shape[axis_name]}")
    xyz = xyz.to(torch.float32)
    offset = _offset(mesh, axis_name, shard_n)
    rows = torch.arange(b, device=xyz.device)

    def champion(value: torch.Tensor, local: torch.Tensor):
        packet = torch.cat([value[:, None], (local + offset).to(torch.float32)[:, None], xyz[rows, local]], dim=1)
        every = gather_rows(packet[:, None, :], mesh, axis_name, dim=1)     # (b, size, 5)
        best = torch.argmax(every[:, :, 0], dim=1)                       # first maximum: the lowest rank
        won = every[rows, best]
        return won[:, 1].to(torch.int32), won[:, 2:]

    first = torch.full((b,), 1.0 if mesh.index(axis_name) == 0 else 0.0, device=xyz.device)
    _, pt = champion(first, torch.zeros((b,), dtype=torch.int64, device=xyz.device))
    idx = torch.zeros((b, m), dtype=torch.int32, device=xyz.device)
    min_d = torch.full((b, shard_n), 1e10, dtype=torch.float32, device=xyz.device)
    for i in range(1, m):
        d = torch.zeros((b, shard_n), dtype=torch.float32, device=xyz.device)
        for c in range(3):
            diff = xyz[:, :, c] - pt[:, None, c]
            d = d + diff * diff
        min_d = torch.minimum(min_d, d)
        local = torch.argmax(min_d, dim=-1)
        idx[:, i], pt = champion(min_d[rows, local], local)
    return idx


def sharded_sa_level(
    mlp: nn.Module,
    xyz: torch.Tensor,
    features: torch.Tensor,
    *,
    npoint: int,
    nsample: int,
    mesh: Mesh,
    axis_name: str = "points",
    use_xyz: bool = True,
):
    """One set-abstraction level with the point axis split along
    ``axis_name``, composed as ``models.backbone.PointNet2SAModule``:
    sharded FPS, the sharded centre and feature gathers, the sharded exact
    kNN (the eval path's dilated kNN: the first k of the sorted dilated
    candidates), the sharded grouping, EdgeConv centring, the level's own
    SharedMLP ``mlp`` on the ``(b, npoint, k)`` tables (the same on every
    rank of the axis) and the neighbour max-pool.

    ``xyz`` ``(b, shard_n, 3)`` and ``features`` ``(b, shard_n, c)`` are
    this rank's shards. Returns ``(new_xyz, center_idx, sample_idx,
    pooled)`` (``SALevelOutput``'s order), on every rank of the axis; the
    geometry equals the single-device module's bit for bit.
    """
    center_idx = sharded_fps(xyz, npoint, mesh, axis_name)
    new_xyz = sharded_gather(xyz, center_idx, mesh, axis_name)
    center_feats = sharded_gather(features, center_idx, mesh, axis_name)
    sample_idx, _ = sharded_knn(xyz, new_xyz, nsample, mesh, axis_name)
    grouped_xyz = sharded_group(xyz, sample_idx, mesh, axis_name) - new_xyz[:, :, None, :]
    grouped_feats = sharded_group(features, sample_idx, mesh, axis_name)
    if nsample > 1:
        grouped_feats = grouped_feats - center_feats[:, :, None, :]
    if use_xyz:
        new_features = torch.cat([grouped_xyz.to(grouped_feats.dtype), grouped_feats], dim=-1)
    else:
        new_features = grouped_feats
    return new_xyz, center_idx, sample_idx, mlp(new_features).amax(dim=2)
