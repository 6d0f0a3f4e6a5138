"""Point-axis-sharded training of the PatchAugNet and PPT-Net descriptor
trunks.

Port of ``patchaugnet_tpu/parallel/sharded_train.py``: the eval
decomposition of ``sharded_model`` in train mode. Every train-mode
BatchNorm takes its statistics over the whole mesh
(``nn.core.batch_stats_group``): a stage whose input is split over the
points (FP0, the finest VLAD scale) then reduces over the whole (B, N)
population, and a stage whose input every rank of the points axis holds
whole averages equal copies, which is its batch's statistics. The
gradients flow through every collective (each carries autograd), every
rank computes the same loss, and the gradients are averaged over the
mesh as in the data-parallel step (``mesh``), which leaves the
single-device gradients on every rank.

The loss is the place-recognition term of ``train.make_loss_fn``. Two
faults of the JAX step are not carried over (ROADMAP C):
``build_sharded_train_step`` raises where the config enables a patch loss
or weights the place-recognition term by anything but 1.0 (the JAX step
drops them without a word), and it applies the zero-loss gate on the
total, as every other step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .. import losses as L
from ..nn.core import batch_stats_group
from .mesh import Mesh, all_reduce_gradients, gather_rows
from .sharded_model import _sharded_pyramid

__all__ = [
    "build_sharded_train_step",
    "sharded_patchaugnet_train_forward",
    "sharded_pptnet_train_forward",
]


def sharded_patchaugnet_train_forward(
    model: nn.Module,
    x: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "points",
) -> torch.Tensor:
    """Train-mode descriptor forward of a PatchAugNet (or a PPT-Net:
    ``sharded_pptnet_train_forward``, normalised where its
    ``use_normalize`` is set) with the point axis split along
    ``axis_name``: ``x`` is this rank's ``(b, n / size, 3)`` shard, ``b``
    its rows on a 2-D mesh. Returns the ``(b, OUTPUT_DIM)`` descriptors,
    on every rank of the axis; the model's running statistics update in
    place, the same on every rank."""
    model.train()
    with batch_stats_group(mesh.group(), mesh.size):
        return _sharded_pyramid(model, x, mesh, axis_name)[0]


# the same pyramid: PPT-Net's four levels and SPVLAD scales
sharded_pptnet_train_forward = sharded_patchaugnet_train_forward


def build_sharded_train_step(
    cfg: Dict[str, Any],
    mesh: Mesh,
    *,
    axis_name: str = "points",
    batch_axis: Optional[str] = None,
) -> Callable:
    """``step(state, clouds) -> (state, metrics)`` with the point axis of
    the training clouds split along ``axis_name``: ``clouds`` is this
    rank's ``(rows, n / size, 3)`` shard of the flattened tuple batch (its
    rows where ``batch_axis`` splits the batch), ``state`` a
    ``train.TrainState`` whose model is a PatchAugNet (``model_type``
    ``patch_aug_net``) or a PPT-Net (``pptnet`` / ``pptnet_l2_norm``),
    the same on every rank.

    The loss is the place-recognition term (quadruplet by default) on the
    whole batch's descriptors; the backward runs through every collective,
    the gradients are averaged over the mesh, a total of 1e-10 or less
    zeroes them (the zero-loss gate), and one optimizer update follows.
    Raises ``ValueError`` for a config that enables a patch loss or weights
    the place-recognition term by anything but 1.0: this step computes that
    term alone.
    """
    from ..train.step import _split_tuple

    model_type = cfg.get("model_type", "patch_aug_net")
    if model_type not in ("patch_aug_net", "pptnet", "pptnet_l2_norm"):
        raise ValueError(f"model_type={model_type!r}: the point-sharded step trains patch_aug_net, pptnet and "
                         f"pptnet_l2_norm")
    if model_type == "patch_aug_net" and (cfg.get("use_patch_recon") or cfg.get("use_patch_feature_contrast")):
        raise ValueError("the point-sharded step computes the place-recognition loss only: set use_patch_recon and "
                         "use_patch_feature_contrast to False (the data-parallel step trains the patch losses)")
    if cfg.get("weight_place_recognition", 1.0) != 1.0:
        raise ValueError(f"weight_place_recognition={cfg['weight_place_recognition']}: the point-sharded step "
                         f"computes the place-recognition loss alone, at weight 1.0")
    batch_size = cfg["TRAIN_BATCH_SIZE"]
    num_pos = cfg["TRAIN_POSITIVES_PER_QUERY"]
    num_neg = cfg["TRAIN_NEGATIVES_PER_QUERY"]
    pr_loss = L.get_loss_func(cfg.get("LOSS_FUNCTION", "quadruplet"))

    def step(state, clouds):
        net = state.model
        clouds = torch.as_tensor(clouds, dtype=torch.float32, device=mesh.device)
        state.optimizer.zero_grad(set_to_none=True)
        desc = sharded_patchaugnet_train_forward(net, clouds, mesh, axis_name=axis_name)
        if batch_axis is not None:
            desc = gather_rows(desc, mesh, batch_axis)
        q, pos, neg, other = _split_tuple(desc, batch_size, num_pos, num_neg)
        loss = pr_loss(q, pos, neg, other, cfg["MARGIN_1"], cfg["MARGIN_2"],
                       use_min=cfg.get("TRIPLET_USE_BEST_POSITIVES", False), lazy=cfg.get("LOSS_LAZY", True),
                       ignore_zero_loss=cfg.get("LOSS_IGNORE_ZERO_BATCH", False))
        loss.backward()
        all_reduce_gradients(net, mesh)
        state.apply_gradients(keep=loss.detach() > 1e-10)
        loss = loss.detach()
        return state, {"place_recognition": loss, "total": loss}

    return step
