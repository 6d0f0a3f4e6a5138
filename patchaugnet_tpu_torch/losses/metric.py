"""Global-descriptor metric losses.

Port of ``patchaugnet_tpu/losses/metric.py``, the counterparts of the
reference's ``losses/pointnetvlad_loss.py``:
  - :func:`best_pos_distance`    (:9-15)
  - :func:`triplet_loss`         (:18-45) + wrapper (:48-50)
  - :func:`quadruplet_loss`      (:53-105)
  - :func:`hphn_quadruplet_loss` (:157-167)

All take ``(B, 1, D)`` query / other_neg, ``(B, P, D)`` positives and
``(B, N, D)`` negatives, the tuple-batch splits of the train step.
"""
from __future__ import annotations

from typing import Tuple

import torch


def best_pos_distance(query: torch.Tensor, pos_vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min / max squared distance from query to its positives: ``(B,), (B,)``."""
    diff = ((pos_vecs - query) ** 2).sum(dim=2)             # (B, P)
    return diff.amin(dim=1), diff.amax(dim=1)


def _hinge_or_softplus(loss: torch.Tensor, soft_margin: bool) -> torch.Tensor:
    if soft_margin:
        return torch.log1p(torch.exp(torch.clamp_max(loss, 88.0)))
    return torch.clamp_min(loss, 0.0)


def _reduce(loss: torch.Tensor, lazy: bool, ignore_zero_loss: bool, sum_not_mean: bool = False) -> torch.Tensor:
    # loss: (B, N) per-negative hinge values.
    if lazy:
        per_query = loss.amax(dim=1)
    elif sum_not_mean:
        per_query = loss.sum(dim=1)
    else:
        per_query = loss.mean(dim=1)
    if ignore_zero_loss:
        hard = (per_query > 1e-16).to(loss.dtype)
        return per_query.sum() / (hard.sum() + 1e-16)
    return per_query.mean()


def triplet_loss(
    q_vec: torch.Tensor,
    pos_vecs: torch.Tensor,
    neg_vecs: torch.Tensor,
    margin: float,
    use_min: bool = False,
    lazy: bool = False,
    ignore_zero_loss: bool = False,
) -> torch.Tensor:
    min_pos, max_pos = best_pos_distance(q_vec, pos_vecs)
    positive = min_pos if use_min else max_pos
    neg_d = ((neg_vecs - q_vec) ** 2).sum(dim=2)            # (B, N)
    loss = torch.clamp_min(margin + positive[:, None] - neg_d, 0.0)
    # the reference's triplet sums over negatives in the non-lazy branch
    # (pointnetvlad_loss.py:38) where the quadruplet loss averages (:77)
    return _reduce(loss, lazy, ignore_zero_loss, sum_not_mean=True)


def triplet_loss_wrapper(
    q_vec, pos_vecs, neg_vecs, other_neg, m1, m2,
    use_min=False, lazy=False, ignore_zero_loss=False, soft_margin=False,
):
    del other_neg, m2, soft_margin
    return triplet_loss(q_vec, pos_vecs, neg_vecs, m1, use_min, lazy, ignore_zero_loss)


def quadruplet_loss(
    q_vec: torch.Tensor,
    pos_vecs: torch.Tensor,
    neg_vecs: torch.Tensor,
    other_neg: torch.Tensor,
    m1: float,
    m2: float,
    use_min: bool = False,
    lazy: bool = False,
    ignore_zero_loss: bool = False,
    soft_margin: bool = False,
) -> torch.Tensor:
    min_pos, max_pos = best_pos_distance(q_vec, pos_vecs)
    positive = (min_pos if use_min else max_pos)[:, None]   # (B, 1)

    neg_d = ((neg_vecs - q_vec) ** 2).sum(dim=2)            # (B, N)
    first = _reduce(_hinge_or_softplus(m1 + positive - neg_d, soft_margin), lazy, ignore_zero_loss)

    other_d = ((neg_vecs - other_neg) ** 2).sum(dim=2)      # (B, N)
    second = _reduce(_hinge_or_softplus(m2 + positive - other_d, soft_margin), lazy, ignore_zero_loss)
    return first + second


def hphn_quadruplet_loss(
    q_vec, pos_vecs, neg_vecs, other_neg, m1, m2,
    use_min=False, lazy=False, ignore_zero_loss=False, soft_margin=False,
) -> torch.Tensor:
    del m2, use_min, lazy, ignore_zero_loss, soft_margin
    _, max_pos = best_pos_distance(q_vec, pos_vecs)
    min_neg, _ = best_pos_distance(q_vec, neg_vecs)
    min_other_neg, _ = best_pos_distance(other_neg, neg_vecs)
    hard_neg = torch.minimum(min_neg, min_other_neg)
    return torch.clamp_min(m1 + max_pos - hard_neg, 0.0).mean()
