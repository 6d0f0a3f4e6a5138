"""PointNet++ backbone of PatchAugNet and PPT-Net.

Port of ``PointNet2SAModule``, ``PointNet2SAModuleMSG``,
``PointNet2FPModule`` and ``index_provenance`` of
``patchaugnet_tpu/models/backbone.py``:

- SA level: FPS -> gather -> EdgeConv grouping (kNN, dilation) ->
  SharedMLP -> neighbour max-pool, and in PPT-Net the grouped
  self-attention after it (``gp``);
- multi-scale SA level: one FPS, then per scale a grouper (kNN or ball),
  its SharedMLP and max-pool; the scales concatenated;
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


class MSGLevelOutput(NamedTuple):
    new_xyz: torch.Tensor      # (B, npoint, 3)
    center_idx: torch.Tensor   # (B, npoint) int32
    sample_idx: torch.Tensor   # (B, npoint, sum(nsamples)) int32, the scales concatenated
    features: torch.Tensor     # (B, npoint, sum of each scale's mlp[-1])


class PointNet2SAModuleMSG(nn.Module):
    """Multi-scale set abstraction (reference ``PointNet2SAModuleMSG``):
    one FPS centre set, one grouper per scale (the ball query at
    ``radii[i]`` where it is not None, else the dilated kNN), each scale
    with its own SharedMLP ``mlp{i}`` and neighbour max-pool. Features
    concatenate over channels, sample indices over the neighbour axis.

    ``in_features`` is the width of the level's input features; scale i's
    MLP sees ``3 + in_features`` channels with ``use_xyz``, else
    ``in_features``. ``dtype`` as in :class:`PointNet2SAModule`: every
    index is the f32 path's.
    """

    def __init__(self, npoint: int, nsamples: Sequence[int], in_features: int, mlps: Sequence[Sequence[int]],
                 radii: Optional[Sequence[Optional[float]]] = None, knn_dilation: int = 1, use_xyz: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(nsamples) != len(mlps) or (radii is not None and len(radii) != len(mlps)):
            raise ValueError(f"PointNet2SAModuleMSG: {len(nsamples)} nsamples, {len(mlps)} mlps, "
                             f"{None if radii is None else len(radii)} radii")
        self.npoint, self.nsamples, self.knn_dilation, self.use_xyz = npoint, tuple(nsamples), knn_dilation, use_xyz
        self.radii = tuple(radii) if radii is not None else (None,) * len(mlps)
        width = in_features + 3 if use_xyz else in_features
        for i, mlp in enumerate(mlps):
            setattr(self, f"mlp{i}", SharedMLP(width, mlp, dtype))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor) -> MSGLevelOutput:
        center_idx = ops.farthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather(xyz, center_idx)
        center_feats = ops.gather(features, center_idx)
        feats, idx = [], []
        for i, (nsample, radius) in enumerate(zip(self.nsamples, self.radii)):
            grouped = ops.query_and_group_edge(
                xyz, new_xyz, features, center_feats,
                nsample=nsample, radius=radius, knn_dilation=self.knn_dilation, use_xyz=self.use_xyz,
            )
            feats.append(getattr(self, f"mlp{i}")(grouped.new_features).amax(dim=2))
            idx.append(grouped.sample_idx)
        return MSGLevelOutput(new_xyz, center_idx, torch.cat(idx, dim=-1), torch.cat(feats, dim=-1))


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
