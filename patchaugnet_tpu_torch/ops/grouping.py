"""Gather / group / 3-NN interpolation (channels-last ``(b, n, c)``).

Port of ``patchaugnet_tpu/ops/grouping.py``: ``gather``, ``group``,
``three_nn``, ``three_interpolate``, ``interpolate_features``,
``query_and_group_edge`` (ball, kNN or given neighbours),
``query_and_group`` and ``group_all``. Indices come out of the public
functions as int32, as in the JAX package; :func:`gather` widens them to
int64 for ``index_select``. Callers pass in-range indices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import contracts
from .knn import ball_query, dilated_knn, knn


def gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, j, c] = features[b, idx[b, j], c]``.

    Args:
      features: ``(b, n, c)`` of any dtype.
      idx: ``(b, m)`` integer indices, each in ``[0, n)``.
    Returns: ``(b, m, c)``, as one flat row gather with batch offsets.
    """
    if features.dim() != 3:
        raise ValueError(f"features: expected (B, N, C), got {tuple(features.shape)}")
    contracts.check_indices(idx, "idx", rank=2)
    contracts.check_same_batch(features, idx, "features", "idx")
    b, n, c = features.shape
    base = torch.arange(b, device=idx.device, dtype=torch.int64)[:, None] * n
    flat = (idx.to(torch.int64) + base).reshape(-1)
    return features.reshape(b * n, c).index_select(0, flat).reshape(b, idx.shape[1], c)


def group(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, j, s, c] = features[b, idx[b, j, s], c]``: ``(b, m, k, c)``."""
    contracts.check_indices(idx, "idx", rank=3)
    b, m, k = idx.shape
    return gather(features, idx.reshape(b, m * k)).reshape(b, m, k, features.shape[-1])


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 3 nearest neighbours of ``unknown`` within ``known``.

    Returns ``(dist, idx)``, both ``(b, n, 3)``: euclidean distances and
    int32 indices, ascending, the lowest index on ties. This is
    :func:`ops.knn.knn` at k=3: on the card the kNN kernel (K2) forms each
    distance as ``pairwise_sqdist`` does and never writes the ``(b, n, m)``
    matrix; on the CPU it is the top-3 extraction of that matrix. (The JAX
    package extracts from the formed matrix on every device; the indices
    and squared distances are the same bits.)
    """
    idx, d2 = knn(known, unknown, 3)
    return torch.sqrt(d2), idx


def three_interpolate(
    features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """Inverse-distance-weighted 3-point interpolation.

    Args:
      features: ``(b, m, c)`` source features.
      idx: ``(b, n, 3)`` neighbour indices into the m axis.
      weight: ``(b, n, 3)`` weights.
    Returns: ``(b, n, c)``, summed in f32 in neighbour order.
    """
    out = None
    for j in range(idx.shape[-1]):
        term = gather(features, idx[..., j]).to(torch.float32) * weight[..., j : j + 1].to(
            torch.float32
        )
        out = term if out is None else out + term
    return out.to(features.dtype)


def interpolate_features(
    unknown_xyz: torch.Tensor, known_xyz: torch.Tensor, known_feats: torch.Tensor
) -> torch.Tensor:
    """The full FP-module interpolation step."""
    dist, idx = three_nn(unknown_xyz, known_xyz)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)
    return three_interpolate(known_feats, idx, weight)


class GroupedEdgeFeatures(NamedTuple):
    new_features: torch.Tensor   # (b, m, k, 3 + c) centred xyz ++ centred feats
    grouped_xyz: torch.Tensor    # (b, m, k, 3) un-centred grouped coordinates
    sample_idx: torch.Tensor     # (b, m, k) int32 neighbour indices


def _neighbours(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    nsample: int,
    radius: Optional[float],
    knn_dilation: int,
    generator: Optional[torch.Generator],
    approx_recall: Optional[float],
) -> torch.Tensor:
    """The neighbour table of a query + group: the ball query at ``radius``,
    else the dilated kNN (K2 on the card)."""
    if radius is not None:
        return ball_query(radius, nsample, xyz, new_xyz)
    return dilated_knn(xyz, new_xyz, nsample, knn_dilation, generator=generator, approx_recall=approx_recall)


def query_and_group_edge(
    xyz: torch.Tensor,
    new_xyz: Optional[torch.Tensor],
    features: Optional[torch.Tensor],
    center_features: Optional[torch.Tensor],
    *,
    nsample: int,
    radius: Optional[float] = None,
    knn_dilation: int = 1,
    use_xyz: bool = True,
    idx: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    approx_recall: Optional[float] = None,
) -> GroupedEdgeFeatures:
    """EdgeConv-style query + group (reference ``QueryAndGroup_Edge``).

    The neighbours are ``idx`` when given, else the ball query at
    ``radius``, else the dilated kNN on the f32 xyz (``generator`` shuffles
    the k neighbours at ``knn_dilation > 1``, the JAX version's ``key``;
    ``approx_recall`` as ``ops.knn``). ``new_xyz`` None queries ``xyz``
    itself. Grouped xyz are centred on ``new_xyz``; grouped features are
    centred on ``center_features`` when ``nsample > 1``. Output layout is
    channels-last: ``(b, m, k, 3 + c)`` with ``use_xyz``, ``(b, m, k, c)``
    without, the centred xyz alone when ``features`` is None; at the
    features' dtype: below f32 the centred xyz are rounded to it (the JAX
    version concatenates in f32, and the next product rounds the same
    values).
    """
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        idx = _neighbours(xyz, new_xyz, nsample, radius, knn_dilation, generator, approx_recall)
    o_grouped_xyz = group(xyz, idx)                        # (b, m, k, 3)
    grouped_xyz = o_grouped_xyz - new_xyz[:, :, None, :]
    if features is None:
        if not use_xyz:
            raise ValueError("query_and_group_edge: need features or use_xyz")
        return GroupedEdgeFeatures(grouped_xyz, o_grouped_xyz, idx)
    grouped_feats = group(features, idx)                   # (b, m, k, c)
    if nsample > 1:
        grouped_feats = grouped_feats - center_features[:, :, None, :]
    if not use_xyz:
        return GroupedEdgeFeatures(grouped_feats, o_grouped_xyz, idx)
    new_features = torch.cat([grouped_xyz.to(grouped_feats.dtype), grouped_feats], dim=-1)
    return GroupedEdgeFeatures(new_features, o_grouped_xyz, idx)


def query_and_group(
    xyz: torch.Tensor,
    new_xyz: Optional[torch.Tensor],
    features: Optional[torch.Tensor],
    *,
    nsample: int,
    radius: Optional[float] = None,
    use_xyz: bool = True,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain (non-edge) query + group (reference ``QueryAndGroup``,
    ``pointops.py:476-516``): the neighbours as :func:`query_and_group_edge`
    finds them (no shuffle), grouped xyz centred on the query, grouped
    features not centred. Returns ``(b, m, k, 3 + c)`` (``(b, m, k, c)``
    without ``use_xyz``, ``(b, m, k, 3)`` without features), the
    concatenation at the promoted dtype, as in the JAX version."""
    if new_xyz is None:
        new_xyz = xyz
    if idx is None:
        idx = _neighbours(xyz, new_xyz, nsample, radius, 1, None, None)
    grouped_xyz = group(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        if not use_xyz:
            raise ValueError("query_and_group: need features or use_xyz")
        return grouped_xyz
    grouped_feats = group(features, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1)
    return grouped_feats


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor], use_xyz: bool = True) -> torch.Tensor:
    """Reference ``GroupAll`` (``pointops.py:637-661``): one group of all
    points, ``(b, 1, n, 3 + c)`` channels-last (``(b, 1, n, c)`` without
    ``use_xyz``; the xyz alone without features)."""
    grouped_xyz = xyz[:, None, :, :]
    if features is None:
        return grouped_xyz
    grouped = features[:, None, :, :]
    if use_xyz:
        return torch.cat([grouped_xyz, grouped], dim=-1)
    return grouped
