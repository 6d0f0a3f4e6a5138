"""The TruncatedSmoothAP trainer (the MinkLoc3Dv2 pipeline).

Port of ``patchaugnet_tpu/train/smoothap.py``. The reference trains
MinkLoc3Dv2 on flat batches of single clouds with (B, B) positives and
negatives masks (Minkloc3D_V2/models/losses/loss.py,
losses/truncated_smoothap.py), each anchor entering with one of its
positives. One step embeds every cloud in train mode, takes the
``truncated_smooth_ap`` loss and its backward, and applies AdamW (Adam
without a weight decay) under a MultiStepLR schedule counted in steps.

``torch.optim.AdamW``'s decoupled decay is optax ``adamw``'s update up to
rounding, and, as optax applies it with no mask, every parameter decays:
BatchNorm scales and biases and GeM's ``p`` too.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.scene_dataset import SceneDataset
from ..losses import truncated_smooth_ap
from ..serving import global_desc
from .state import Schedule, TrainState, Tx


def sample_smoothap_batch(scene: SceneDataset, batch_size: int, rng=None) -> Optional[List[int]]:
    """A pair-expanded batch: ``batch_size // 2`` anchors with a positive,
    each followed by one of its positives (the MinkLoc BatchSampler
    pattern), drawn from ``rng`` (a ``random.Random``; the ``random``
    module when None). None when too few records have a positive."""
    rng = rng or random
    skip = scene.data_cfg["skip_trip_itself"]
    candidates = [i for i in range(len(scene.records)) if scene.get_tuple(i, -1, skip).positive_indices]
    if len(candidates) < batch_size // 2:
        return None
    batch: List[int] = []
    for a in rng.sample(candidates, batch_size // 2):
        batch.append(a)
        batch.append(rng.choice(scene.get_tuple(a, -1, skip).positive_indices))
    return batch[:batch_size]


def build_masks(scene: SceneDataset, batch_indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(B, B) positives and negatives masks from the scene's tuples; a
    record in neither set (between the two radii) is in neither mask."""
    b = len(batch_indices)
    skip = scene.data_cfg["skip_trip_itself"]
    pos = np.zeros((b, b), bool)
    neg = np.zeros((b, b), bool)
    for i, qi in enumerate(batch_indices):
        t = scene.get_tuple(qi, -1, skip)
        pset, nset = set(t.positive_indices), set(t.negative_indices)
        for j, rj in enumerate(batch_indices):
            if i == j:
                continue
            if rj in pset:
                pos[i, j] = True
            elif rj in nset:
                neg[i, j] = True
    return pos, neg


def smoothap_optimizer(lr_schedule: Schedule, weight_decay: Optional[float] = None) -> Tx:
    """AdamW at ``weight_decay`` (Adam without one), optax's defaults
    (betas 0.9, 0.999, eps 1e-8), at ``lr_schedule``."""
    def make(params, lr: float) -> torch.optim.Optimizer:
        if weight_decay:
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    return Tx(make=make, schedule=lr_schedule)


def build_smoothap_train_step(
    model: nn.Module,
    lr_schedule: Schedule,
    weight_decay: Optional[float] = None,
    tau1: float = 0.01,
    positives_per_query: int = 4,
) -> Tuple[Callable, Tx]:
    """``(step(state, clouds, pos_mask, neg_mask) -> (state, stats), tx)``;
    ``tx`` goes to ``create_train_state``. The step runs ``state.model``
    in train mode on the device it lies on (the BatchNorm statistics
    update in place), then one optimizer update; ``stats`` are detached
    device tensors (``loss``, ``ap``, ``positives_per_query``,
    ``recall_at_1``, ``avg_embedding_norm``)."""
    del model               # the step runs state.model, as the port's other steps

    def step(state: TrainState, clouds, pos_mask, neg_mask) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        net = state.model
        device = next(net.parameters()).device
        net.train()
        clouds = torch.as_tensor(clouds, dtype=torch.float32, device=device)
        pos = torch.as_tensor(pos_mask, dtype=torch.bool, device=device)
        neg = torch.as_tensor(neg_mask, dtype=torch.bool, device=device)
        state.optimizer.zero_grad(set_to_none=True)
        loss, stats = truncated_smooth_ap(global_desc(net(clouds)), pos, neg, tau1=tau1,
                                          positives_per_query=positives_per_query)
        loss.backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in stats.items()}

    return step, smoothap_optimizer(lr_schedule, weight_decay)


def train_one_epoch_smoothap(
    state: TrainState,
    step: Callable,
    scene: SceneDataset,
    batch_size: int,
    batches_per_epoch: int,
    rng: Optional[random.Random] = None,
    get_clouds: Optional[Callable] = None,
    logger=None,
) -> Tuple[TrainState, Dict[str, float]]:
    """One SmoothAP epoch: sample pair-expanded batches, build their masks,
    run the step. Returns ``(state, summary)``, the summary the mean
    ``loss`` and ``ap`` over the batches (``state.step`` counts them)."""
    rng = rng or random.Random(0)
    get_clouds = get_clouds or (lambda idx: scene.get_clouds(idx)[0])
    agg: Dict[str, list] = {}
    for _ in range(batches_per_epoch):
        batch_idx = sample_smoothap_batch(scene, batch_size, rng)
        if batch_idx is None:
            continue
        pos, neg = build_masks(scene, batch_idx)
        state, stats = step(state, get_clouds(batch_idx), pos, neg)
        for k in ("loss", "ap"):
            agg.setdefault(k, []).append(stats[k].item())
    summary = {k: float(np.mean(v)) for k, v in agg.items() if v}
    if logger and summary:
        logger.info(f"smoothap epoch: {summary}")
    return state, summary


def multistep_schedule(lr: float, milestones: Sequence[int], steps_per_epoch: int, gamma: float = 0.1) -> Schedule:
    """torch MultiStepLR counted in steps: ``lr`` times ``gamma`` for every
    milestone epoch ``m`` with ``m * steps_per_epoch <= count`` (optax's
    piecewise-constant schedule)."""
    boundaries = [int(m) * steps_per_epoch for m in milestones]

    def schedule(count: int) -> float:
        rate = lr
        for b in boundaries:
            if count >= b:
                rate *= gamma
        return rate

    return schedule
