"""PointNet++ backbone of PatchAugNet and PPT-Net.

Port of ``PointNet2SAModule``, ``PointNet2FPModule`` and
``index_provenance`` of ``patchaugnet_tpu/models/backbone.py``:

- SA level: FPS -> gather -> EdgeConv grouping (kNN, dilation) ->
  SharedMLP -> neighbour max-pool, and in PPT-Net the grouped
  self-attention after it (``gp``);
- FP level: 3-NN inverse-distance interpolation + SharedMLP;
- index provenance: every level's centre/sample indices mapped back to
  the original cloud.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import ops
from ..nn import GroupSA, SharedMLP


class SALevelOutput(NamedTuple):
    new_xyz: torch.Tensor      # (B, npoint, 3)
    center_idx: torch.Tensor   # (B, npoint) int32 indices into this level's input
    sample_idx: torch.Tensor   # (B, npoint, nsample) int32 indices into this level's input
    features: torch.Tensor     # (B, npoint, C_out)


class PointNet2SAModule(nn.Module):
    """Set-abstraction level with EdgeConv grouping.

    ``in_features`` is the width of the level's input features; the MLP
    sees ``3 + in_features`` channels (centred xyz ++ centred features).
    ``gp`` adds ``GroupSA`` with ``gp`` groups after the max-pool, as
    ``sa`` (PPT-Net). ``dtype`` is the feature path's compute dtype (None:
    f32); FPS and the kNN run on the f32 xyz, so every index is the f32
    path's. ``knn_approx_recall`` is ``ops.knn``'s ``approx_recall``.
    """

    def __init__(self, npoint: int, nsample: int, in_features: int, mlp: Sequence[int],
                 knn_dilation: int = 1, gp: Optional[int] = None, dtype: Optional[torch.dtype] = None,
                 knn_approx_recall: Optional[float] = None):
        super().__init__()
        self.npoint, self.nsample, self.knn_dilation = npoint, nsample, knn_dilation
        self.knn_approx_recall = knn_approx_recall
        self.mlp = SharedMLP(in_features + 3, mlp, dtype)
        self.sa = GroupSA(mlp[-1], gp, dtype) if gp is not None else None

    def forward(self, xyz: torch.Tensor, features: torch.Tensor) -> SALevelOutput:
        center_idx = ops.farthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather(xyz, center_idx)
        center_feats = ops.gather(features, center_idx)
        grouped = ops.query_and_group_edge(
            xyz, new_xyz, features, center_feats,
            nsample=self.nsample, knn_dilation=self.knn_dilation, approx_recall=self.knn_approx_recall,
        )
        h = self.mlp(grouped.new_features).amax(dim=2)    # neighbour max-pool
        if self.sa is not None:
            h = self.sa(h)
        return SALevelOutput(new_xyz, center_idx, grouped.sample_idx, h)


class PointNet2FPModule(nn.Module):
    """Feature-propagation level: 3-NN interpolate + SharedMLP.

    ``in_features`` is the known features' width plus the unknown ones'
    (0 when the level gets none). At a compute ``dtype`` the 3-NN runs on
    the f32 xyz, the interpolation sums in f32 and returns the known
    features' dtype, and both sides are cast to ``dtype`` before the
    concatenation (the raw xyz of level 0 included).
    """

    def __init__(self, in_features: int, mlp: Sequence[int], dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.mlp = SharedMLP(in_features, mlp, dtype)

    def forward(self, unknown_xyz: torch.Tensor, known_xyz: torch.Tensor,
                unknown_feats: Optional[torch.Tensor], known_feats: torch.Tensor) -> torch.Tensor:
        h = ops.interpolate_features(unknown_xyz, known_xyz, known_feats)
        if unknown_feats is not None:
            if self.compute_dtype is not None:
                h, unknown_feats = h.to(self.compute_dtype), unknown_feats.to(self.compute_dtype)
            h = torch.cat([h, unknown_feats], dim=-1)
        return self.mlp(h)


def index_provenance(
    center_idx: Sequence[torch.Tensor], sample_idx: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Compose per-level indices into original-cloud indices.

    Level-i centre indices index into level-(i-1)'s centres; composing
    through level 0 yields int32 indices into the raw input cloud.
    """
    center_origin = [center_idx[0]]
    sample_origin = [sample_idx[0]]
    for i in range(1, len(center_idx)):
        prev = center_origin[i - 1][..., None]             # (B, m_{i-1}, 1)
        center_origin.append(ops.gather(prev, center_idx[i])[..., 0])
        sample_origin.append(ops.group(prev, sample_idx[i])[..., 0])
    return center_origin, sample_origin
