"""Batch-hard mining losses and pose-estimation losses.

Port of ``patchaugnet_tpu/losses/miners.py``:
  - :func:`batch_hard_triplet_loss` (``BatchHardTripletLossWithMasks``,
    MinkLoc3Dv2 ``models/losses/loss.py:78-101``): per anchor the hardest
    positive (largest distance) and hardest negative (smallest), triplet
    margin with swap, averaged over the non-zero triplets;
  - :func:`batch_hard_contrastive_loss` (``loss.py:104-137``);
  - :func:`contrastive_quadruplet_loss` (``pointnetvlad_loss.py:108-154``);
  - :func:`ot_loss` and :func:`pps_loss` (``losses/pose_est_loss.py:9-83``)
    over padded index tables.

The JAX package's dynamic boolean indexing is masked means here too. The
hardest pair's index is the first among ties (``argmax``/``argmin``); the
values' gradients split over ties (``amax``/``amin``), and a hinge's
gradient at its corner is half (``torch.maximum``), as JAX takes them. The
embedding distances are ``pairwise_sqdist``'s matrix form (TF32 off on the
card: ``serving.resolve_device``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..nn.core import l2_normalize
from ..ops.pairwise import pairwise_sqdist

_INF = 1e30


def _hinge(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with ``jnp.maximum``'s gradient (half at x = 0)."""
    return torch.maximum(x, x.new_zeros(()))


def _mine_hard(embeddings, positives_mask, negatives_mask):
    """Distances, the hardest positive (largest distance) and negative
    (smallest) per anchor with their indices, and the anchors that have both."""
    d = torch.sqrt(_hinge(pairwise_sqdist(embeddings[None], embeddings[None])[0]) + 1e-12)
    pos_d = torch.where(positives_mask, d, 0.0)
    neg_d = torch.where(negatives_mask, d, _INF)
    keep = positives_mask.any(dim=1) & negatives_mask.any(dim=1)
    return (d, pos_d.amax(dim=1), pos_d.argmax(dim=1), neg_d.amin(dim=1), neg_d.argmin(dim=1), keep)


def batch_hard_triplet_loss(
    embeddings: torch.Tensor,
    positives_mask: torch.Tensor,
    negatives_mask: torch.Tensor,
    margin: float = 0.2,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Triplet margin with swap over the mined hard triplets of ``(N, D)``
    embeddings with ``(N, N)`` bool masks; the mean over the non-zero
    triplets (AvgNonZeroReducer). Returns ``(loss, stats)``."""
    d, hp, hp_i, hn, hn_i, keep = _mine_hard(embeddings, positives_mask, negatives_mask)
    keep_f = keep.to(embeddings.dtype)
    # swap=True: the negative distance is min(d(a, n), d(p, n))
    neg_dist = torch.minimum(hn, d[hp_i, hn_i])
    per_anchor = _hinge(hp - neg_dist + margin) * keep_f
    nonzero = (per_anchor > 0).to(embeddings.dtype)
    loss = per_anchor.sum() / nonzero.sum().clamp_min(1.0)
    kept = keep_f.sum().clamp_min(1.0)
    stats = {
        "loss": loss,
        "num_triplets": keep.sum(dtype=torch.int32),
        "num_non_zero_triplets": nonzero.sum(),
        "mean_pos_pair_dist": (hp * keep_f).sum() / kept,
        "mean_neg_pair_dist": torch.where(keep, hn, 0.0).sum() / kept,
        "avg_embedding_norm": torch.linalg.vector_norm(embeddings, dim=1).mean(),
    }
    return loss, stats


def batch_hard_contrastive_loss(
    embeddings: torch.Tensor,
    positives_mask: torch.Tensor,
    negatives_mask: torch.Tensor,
    pos_margin: float = 0.2,
    neg_margin: float = 0.65,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Contrastive loss on the mined hard pairs: ``hinge(d_ap - pos_margin)
    + hinge(neg_margin - d_an)``, each averaged over its non-zero set.
    Returns ``(loss, stats)``."""
    _, hp, _, hn, _, keep = _mine_hard(embeddings, positives_mask, negatives_mask)
    keep_f = keep.to(embeddings.dtype)
    pos_term = _hinge(hp - pos_margin) * keep_f
    neg_term = _hinge(neg_margin - hn) * keep_f
    pos_loss = pos_term.sum() / (pos_term > 0).to(embeddings.dtype).sum().clamp_min(1.0)
    neg_loss = neg_term.sum() / (neg_term > 0).to(embeddings.dtype).sum().clamp_min(1.0)
    loss = pos_loss + neg_loss
    stats = {
        "loss": loss,
        "pos_loss": pos_loss,
        "neg_loss": neg_loss,
        "num_pairs": 2 * keep.sum(dtype=torch.int32),
        "avg_embedding_norm": torch.linalg.vector_norm(embeddings, dim=1).mean(),
    }
    return loss, stats


def contrastive_quadruplet_loss(
    q_vec, pos_vecs, neg_vecs, other_neg, m1, m2,
    use_min=False, lazy=True, ignore_zero_loss=False, soft_margin=False,
):
    """The quadruplet loss whose first term splits the batch by whether the
    hardest negative is closer than the positive; on the violated side the
    positive distance is detached (``pointnetvlad_loss.py:108-154``).
    ``q_vec (B, 1, D)``, ``pos_vecs (B, P, D)``, ``neg_vecs (B, N, D)``,
    ``other_neg (B, 1, D)``; ``soft_margin`` is accepted and unused, as in
    the JAX version."""
    del soft_margin
    diff_pos = ((pos_vecs - q_vec) ** 2).sum(dim=2)
    positive = diff_pos.amin(dim=1) if use_min else diff_pos.amax(dim=1)
    min_neg = ((neg_vecs - q_vec) ** 2).sum(dim=2).amin(dim=1)   # (B,)
    violated = min_neg < positive
    l1 = _hinge(m1 + positive.detach() - min_neg)
    l2 = _hinge(m1 + positive - min_neg)
    triplet = torch.where(violated, l1, l2).sum() / q_vec.shape[0]

    second = _hinge(m2 + positive[:, None] - ((neg_vecs - other_neg) ** 2).sum(dim=2))
    second = second.amax(dim=1) if lazy else second.mean(dim=1)
    if ignore_zero_loss:
        hard = (second > 1e-16).to(second.dtype)
        second = second.sum() / (hard.sum() + 1e-16)
    else:
        second = second.mean()
    return triplet + second


def ot_loss(
    scores: torch.Tensor,
    pair_idx: torch.Tensor,
    pair_valid: torch.Tensor,
    unpair0: torch.Tensor,
    unpair0_valid: torch.Tensor,
    unpair1: torch.Tensor,
    unpair1_valid: torch.Tensor,
    use_unpair: bool = True,
) -> torch.Tensor:
    """Optimal-transport matching loss over padded index tables.

    Args:
      scores: ``(B, M+1, N+1)`` log-assignment scores (dustbin row and column).
      pair_idx: ``(B, P, 2)`` matched (i, j); pair_valid ``(B, P)`` bool.
      unpair0/1: ``(B, U)`` unmatched indices in cloud 0 / 1, with their
        ``(B, U)`` bool masks.
    The mean over the batch elements that have a valid pair.
    """
    logscore = -scores
    bidx = torch.arange(scores.shape[0], device=scores.device)[:, None]
    pair_idx = pair_idx.long()

    pv = pair_valid.to(scores.dtype)
    p_scores = logscore[bidx, pair_idx[..., 0], pair_idx[..., 1]]
    total = (p_scores * pv).sum(dim=1) / pv.sum(dim=1).clamp_min(1.0)
    has_pairs = pair_valid.any(dim=1).to(scores.dtype)
    if use_unpair:
        for side, unpair, valid in ((0, unpair0.long(), unpair0_valid), (1, unpair1.long(), unpair1_valid)):
            u = valid.to(scores.dtype)
            s = logscore[bidx, unpair, -1] if side == 0 else logscore[bidx, -1, unpair]
            per_b = (s * u).sum(dim=1) / u.sum(dim=1).clamp_min(1.0)
            total = total + per_b * valid.any(dim=1).to(scores.dtype)
    return (total * has_pairs).sum() / has_pairs.sum().clamp_min(1.0)


def pps_loss(
    src_feat: torch.Tensor,
    tgt_feat: torch.Tensor,
    neg_idxs: torch.Tensor,
    neg_valid: torch.Tensor,
    margin: float = 0.5,
) -> torch.Tensor:
    """Point-pair similarity loss over padded tables
    (``pose_est_loss.py:34-83``): anchors from ``src``, positives from
    ``tgt``, per row the closest of its candidate negatives (the first
    among ties); squared-distance contrast with ``margin``.

    Args:
      src_feat/tgt_feat: ``(B, M, D)``.
      neg_idxs: ``(B, R, 2 + num_keep)`` rows of (src_idx, tgt_pos_idx,
        tgt_neg candidates...); neg_valid ``(B, R)`` bool.
    """
    src = l2_normalize(src_feat, -1)
    tgt = l2_normalize(tgt_feat, -1)
    bidx = torch.arange(src.shape[0], device=src.device)[:, None]
    neg_idxs = neg_idxs.long()
    a = src[bidx, neg_idxs[..., 0]]                        # (B, R, D)
    p = tgt[bidx, neg_idxs[..., 1]]
    cand = tgt[bidx[..., None], neg_idxs[..., 2:]]         # (B, R, K, D)
    an_d = torch.sqrt(((a[:, :, None] - cand) ** 2).sum(-1) + 1e-12)
    hard = an_d.argmin(dim=-1)                             # (B, R)
    n = torch.take_along_dim(cand, hard[..., None, None], dim=2)[:, :, 0]
    v = neg_valid.to(src.dtype)
    nv = v.sum().clamp_min(1.0)
    ap = (((a - p) ** 2).sum(-1) * v).sum() / nv
    an = torch.sqrt(((a - n) ** 2).sum(-1) + 1e-12)
    an = (_hinge(margin - an) ** 2 * v).sum() / nv
    return ap + an
