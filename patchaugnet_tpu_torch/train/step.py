"""The train step of PatchAugNet.

Port of ``patchaugnet_tpu/train/step.py``: the reference's per-batch
train loop body (``train_place_recognition.py:221-392``: forward, quadruplet loss,
patch a2a chamfer, a2b contrast, weighted sum, backward, update) as one
call on the model's device with no host read: the subset of clouds that
feeds the patch losses is formed on the device, and the metrics come
back as device tensors.

Patch inputs (the correspondence tables and the related-cloud mask) are
built on the host from overlap records and passed as fixed-size tables,
as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Union

import torch
from torch import nn

from .. import losses as L
from ..losses.patch_contrast import PatchCorrespondences
from ..ops import farthest_point_sample
from ..serving import build_forward_fn, build_local_forward_fn, resolve_device
from .state import TrainState

__all__ = [
    "make_loss_fn",
    "build_train_step",
    "build_forward_fn",
    "build_local_forward_fn",
    "build_center_fn",
    "empty_patch_inputs",
]


def _split_tuple(desc: torch.Tensor, batch_size: int, num_pos: int, num_neg: int):
    """(B*T, D) -> query (B,1,D), pos (B,P,D), neg (B,N,D), other (B,1,D)
    (run_model's view and split, train_place_recognition.py:166-168)."""
    d = desc.reshape(batch_size, 1 + num_pos + num_neg + 1, -1)
    return (
        d[:, :1],
        d[:, 1 : 1 + num_pos],
        d[:, 1 + num_pos : 1 + num_pos + num_neg],
        d[:, 1 + num_pos + num_neg :],
    )


def _first_true(mask: torch.Tensor, r: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=r, fill_value=0)[0]`` formed on the device:
    the ids of the first ``r`` true entries, then zeros. (``torch.nonzero``
    would read the count back to the host.)"""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < r), pos, r)            # the rest parks at r
    sel = torch.zeros((r + 1,), dtype=torch.int64, device=mask.device)
    sel.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return sel[:r]


def make_loss_fn(model: nn.Module, cfg: Dict[str, Any]) -> Callable:
    """``loss_fn(clouds, corr, cloud_mask) -> (total, metrics)`` on the
    model as it stands: in train mode its BatchNorms normalise with the
    batch statistics and update their running statistics in place.
    ``metrics`` holds each weighted term and ``"total"``.
    """
    batch_size = cfg["TRAIN_BATCH_SIZE"]
    num_pos = cfg["TRAIN_POSITIVES_PER_QUERY"]
    num_neg = cfg["TRAIN_NEGATIVES_PER_QUERY"]
    m1, m2 = cfg["MARGIN_1"], cfg["MARGIN_2"]
    lazy = cfg.get("LOSS_LAZY", True)
    use_min = cfg.get("TRIPLET_USE_BEST_POSITIVES", False)
    ignore_zero = cfg.get("LOSS_IGNORE_ZERO_BATCH", False)
    pr_loss = L.get_loss_func(cfg.get("LOSS_FUNCTION", "quadruplet"))
    use_patches = cfg["model_type"] == "patch_aug_net" and (
        cfg.get("use_patch_recon", False) or cfg.get("use_patch_feature_contrast", False)
    )
    use_a2a = use_patches and cfg.get("use_patch_recon", False)
    use_a2b = use_patches and cfg.get("use_patch_feature_contrast", False)
    w = {
        "place_recognition": cfg.get("weight_place_recognition", 1.0),
        "patch_recon_a2a": cfg.get("weight_patch_recon", 0.25),
        "patch_recon_a2b": cfg.get("weight_patch_feature_contrast", 0.25),
    }
    # the patch losses only touch queries and positives (the reference's
    # related_cloud_idx, patch_aug_net.py:68-74): the branch runs on a
    # fixed-size subset of the tuple batch
    max_patch_clouds = cfg.get("A2A_MAX_CLOUDS", batch_size * (1 + num_pos))

    def loss_fn(clouds: torch.Tensor, corr: PatchCorrespondences,
                cloud_mask: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if not use_patches:
            out = model(clouds)
        else:
            total_clouds = clouds.shape[0]
            r = min(max_patch_clouds, total_clouds)
            # fill rows carry cloud 0 through the branch, so they count in
            # the decoder BatchNorms' batch statistics, as in the JAX step
            sel = _first_true(cloud_mask, r)
            sel_valid = torch.arange(r, device=clouds.device) < cloud_mask.sum()
            out = model(clouds, with_patches=True, patch_rows=sel)
        q, p, n, o = _split_tuple(out.global_desc, batch_size, num_pos, num_neg)
        metrics = {"place_recognition": pr_loss(q, p, n, o, m1, m2, use_min=use_min, lazy=lazy,
                                                ignore_zero_loss=ignore_zero)}
        if use_a2a:
            pd = out.patch_data
            metrics["patch_recon_a2a"] = L.patch_chamfer_loss(
                pd.origin_patches, pd.reconstructed_patches, sel_valid)
        if use_a2b:
            # correspondence cloud ids (flat-batch positions) to subset
            # rows; only valid entries scatter, fill rows park at index
            # total_clouds, which is cut away
            scatter_to = torch.where(sel_valid, sel, total_clouds)
            pos_of = torch.zeros((total_clouds + 1,), dtype=torch.int64, device=clouds.device)
            pos_of = pos_of.scatter(0, scatter_to, torch.arange(r, device=clouds.device))[:total_clouds]
            covered = torch.zeros((total_clouds + 1,), dtype=torch.bool, device=clouds.device)
            covered = covered.scatter(0, scatter_to, True)[:total_clouds]
            q_cloud, n_cloud = corr.row_q_cloud.long(), corr.row_n_cloud.long()
            corr_sub = corr._replace(
                row_q_cloud=pos_of[q_cloud],
                row_n_cloud=pos_of[n_cloud],
                # rows on clouds outside the subset cannot be evaluated
                # there (the real loop never makes them: its rows come
                # from the masked clouds)
                row_valid=corr.row_valid & covered[q_cloud] & covered[n_cloud],
            )
            metrics["patch_recon_a2b"] = L.patch_contrastive_loss(out.patch_data.patch_features, corr_sub, m1)
        total = sum(w[k] * v for k, v in metrics.items())
        metrics = {k: w[k] * v for k, v in metrics.items()}
        metrics["total"] = total
        return total, metrics

    return loss_fn


def build_train_step(model: nn.Module, cfg: Dict[str, Any]) -> Callable:
    """``step(state, clouds, corr, cloud_mask) -> (state, metrics)``.

    clouds: ``(B*T, N, 3)`` flattened tuple batch (tensor or numpy).
    corr: :class:`PatchCorrespondences` (ignored for non-patch models).
    cloud_mask: ``(B*T,)`` bool, the clouds that feed the patch losses
    (the reference's related clouds, patch_aug_net.py:68-74).

    The step runs ``state.model``, which carries the parameters and
    statistics that the JAX step takes from its state, on the device it
    lies on (``create_train_state`` puts it on the card unless the caller
    asks for the CPU); ``model`` is checked here against ``cfg``. The step
    puts the model in train mode, runs the loss and its backward, and
    applies one update to ``state`` in place; a total of 1e-10 or less
    zeroes the gradients (the reference's loss gate,
    train_place_recognition.py:390-392) and the update still runs, as in
    the JAX step. Metrics are detached device tensors. ``REMAT``
    (recomputing the forward in the backward) is not ported: a recomputed
    forward would update the running BatchNorm statistics twice.
    """
    if cfg.get("REMAT", False):
        raise NotImplementedError("REMAT is not ported: leave it unset")
    if (cfg["model_type"] == "patch_aug_net" and cfg.get("use_patch_recon", False)
            and getattr(model, "decoder", None) is None):
        raise ValueError("use_patch_recon needs a model built with its decoder (use_a2a_recon=True)")

    def train_step(state: TrainState, clouds, corr: PatchCorrespondences,
                   cloud_mask) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        net = state.model
        device = next(net.parameters()).device
        net.train()
        clouds = torch.as_tensor(clouds, dtype=torch.float32, device=device)
        cloud_mask = torch.as_tensor(cloud_mask, dtype=torch.bool, device=device)
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = make_loss_fn(net, cfg)(clouds, corr.to(device), cloud_mask)
        total.backward()
        state.apply_gradients(keep=total.detach() > 1e-10)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_center_fn(npoint: int, device: Union[str, torch.device] = "cuda") -> Callable:
    """Level-0 centres for host-side correspondence building: the same
    deterministic FPS as the model's first SA level, so host tables match
    the forward's patch slots. ``(B, N, 3) -> (B, npoint)`` int32."""
    device = resolve_device(device)

    def centers(clouds) -> torch.Tensor:
        return farthest_point_sample(torch.as_tensor(clouds, dtype=torch.float32, device=device), npoint)

    return centers


def empty_patch_inputs(cfg: Dict[str, Any], total_clouds: int) -> Tuple[PatchCorrespondences, torch.Tensor]:
    """Zero correspondence tables and an all-false mask (non-patch
    batches), on the CPU; the step moves them to its device."""
    corr = PatchCorrespondences.empty(cfg.get("A2B_MAX_ROWS", 2048), cfg.get("A2B_MAX_PAIRS", 16))
    return corr, torch.zeros((total_clouds,), dtype=torch.bool)
