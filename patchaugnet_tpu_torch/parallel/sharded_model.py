"""Point-axis-sharded descriptor forwards of PatchAugNet, PPT-Net and
PointNetVLAD.

Port of ``patchaugnet_tpu/parallel/sharded_model.py``. Each rank holds its
shard ``(b, n / size, 3)`` of the clouds' point axis (``size`` ranks along
``axis_name``), and only the stages that scale with n touch the mesh:

  - SA level 0 (n -> SAMPLING[0]): ``sharded_ops.sharded_sa_level``, the
    level's own SharedMLP on the ``(b, npoint, k)`` tables, and PPT-Net's
    grouped self-attention after the pool;
  - the other SA levels and the FP levels down to 1 run on every rank as
    they are: their inputs have SAMPLING[0] points or fewer;
  - FP level 0 (back to the n points) runs on each rank's shard with no
    collective: each point's 3-NN lies among the replicated centres
    (:func:`sharded_fp_level`);
  - the finest VLAD scale sums its two N-sums over the axis
    (``NetVLADBase``'s ``group``); the coarser scales and the heads run on
    every rank.

PointNetVLAD runs whole on each shard: its transforms' max-pools take the
maximum over the axis and its VLAD sums over it.

They take the port's modules (not variable trees) and run their own
layers, in eval mode (no autograd); a model built at a ``COMPUTE_DTYPE``
runs at it. Geometry (FPS, kNN, 3-NN indices) and the features equal the
single-device forward's; the descriptor differs by the order of the
finest scale's sums.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..nn import l2_normalize
from ..serving import _eval_mode
from .mesh import Mesh
from .sharded_ops import sharded_sa_level

__all__ = [
    "sharded_fp_level",
    "sharded_patchaugnet_descriptor",
    "sharded_pointnetvlad_descriptor",
    "sharded_pptnet_descriptor",
]


def sharded_fp_level(
    fp_module: nn.Module,
    unknown_xyz: torch.Tensor,
    known_xyz: torch.Tensor,
    unknown_feats: Optional[torch.Tensor],
    known_feats: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str = "points",
) -> torch.Tensor:
    """One feature-propagation level with the UNKNOWN axis split along
    ``axis_name``: ``unknown_xyz`` / ``unknown_feats`` are this rank's
    shards, ``known_*`` the same on every rank. The 3-NN interpolation
    (kernel K2 at k=3) is per unknown point and the SharedMLP pointwise,
    so the level runs on the shard with no collective and returns this
    rank's shard of the output. In train mode its BatchNorms take the
    shard's statistics unless the caller runs it inside
    ``nn.core.batch_stats_group`` (``sharded_train`` does)."""
    return fp_module(unknown_xyz, known_xyz, unknown_feats, known_feats)


def _sharded_pyramid(model: nn.Module, x: torch.Tensor, mesh: Mesh,
                     axis_name: str) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The descriptor and ``fp_features`` (coarse to fine, the finest this
    rank's shard) of a PatchAugNet or PPT-Net on this rank's point shard
    ``x``, in the mode the model is in."""
    if x.dim() == 4:
        x = x.squeeze(1)
    x = x.to(torch.float32)
    levels = sum(1 for name, _ in model.named_children() if name.startswith("sa"))
    sa0 = model.sa0
    xyz1, _, _, feats1 = sharded_sa_level(sa0.mlp, x, x, npoint=sa0.npoint, nsample=sa0.nsample, mesh=mesh,
                                          axis_name=axis_name)
    if sa0.sa is not None:
        feats1 = sa0.sa(feats1)
    l_xyz, l_feats = [x, xyz1], [x, feats1]
    for i in range(1, levels):
        out = getattr(model, f"sa{i}")(l_xyz[i], l_feats[i])
        l_xyz.append(out.new_xyz)
        l_feats.append(out.features)
    for i in range(levels - 1, 0, -1):
        l_feats[i] = getattr(model, f"fp{i}")(l_xyz[i], l_xyz[i + 1], l_feats[i], l_feats[i + 1])
    unknown = x if getattr(model, "use_origin_pc_in_fp", True) else None
    l_feats[0] = sharded_fp_level(model.fp0, x, xyz1, unknown, l_feats[1], mesh=mesh, axis_name=axis_name)
    fp_features = l_feats[levels - 1::-1]
    desc = model.aggregation(fp_features, groups=[None] * (levels - 1) + [mesh.group(axis_name)])
    if getattr(model, "use_normalize", False):
        desc = l2_normalize(desc, dim=-1)
    if model.compute_dtype is not None:
        desc = desc.to(torch.float32)
        fp_features = [f.to(torch.float32) for f in fp_features]
    return desc, fp_features


def sharded_patchaugnet_descriptor(
    model: nn.Module,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "points",
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """PatchAugNet's (or PPT-Net's: ``sharded_pptnet_descriptor``) eval
    forward over a point-sharded mesh.

    Args:
      model: a ``models.PatchAugNet`` or ``models.PPTNet`` on this rank's
        device (run in eval mode; its mode is restored). PPT-Net's SA0
        runs its GroupSA on the pooled table, and its ``use_normalize``
        tells ``pptnet_l2_norm``.
      x: this rank's ``(b, n / size, 3)`` shard of the clouds (n divisible
        by the axis size; no 4096 cap), ``b`` its rows on a 2-D mesh.

    Returns ``(desc, fp_features)`` as the model's output's
    ``global_desc`` / ``fp_features``: desc ``(b, OUTPUT_DIM)`` on every
    rank of the axis, fp_features coarse to fine (PatchAugNet:
    ``[(b, SAMPLING[1], C), (b, SAMPLING[0], C), (b, n / size, C)]``), the
    last this rank's shard. ``KNN_APPROX_RECALL`` runs the exact kNN, as
    everywhere in the port.
    """
    with _eval_mode(model):
        return _sharded_pyramid(model, x, mesh, axis_name)


# the same pyramid: PPT-Net's four levels and SPVLAD scales
sharded_pptnet_descriptor = sharded_patchaugnet_descriptor


def sharded_pointnetvlad_descriptor(
    model: nn.Module,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "points",
) -> torch.Tensor:
    """PointNetVLAD's eval forward over a point-sharded mesh: the whole
    model on this rank's shard ``x`` ``(b, n / size, 3)``, its two
    transforms' max-pools a maximum over the axis (exact) and its VLAD's
    two N-sums a sum over it. Returns ``(b, FEATURE_OUTPUT_DIM)`` on every
    rank of the axis."""
    with _eval_mode(model):
        return model(x.to(torch.float32), group=mesh.group(axis_name))
