"""TruncatedSmoothAP (the MinkLoc3Dv2 training loss), the
multi-similarity loss and the focal losses.

Port of ``patchaugnet_tpu/losses/extra.py``:
  - :func:`truncated_smooth_ap` (reference
    ``losses/truncated_smoothap.py:11-107``): the reference's dynamic row
    filtering as masked means. The positives a query ranks against are its
    ``positives_per_query`` most similar ones, picked as ``lax.top_k``
    picks them, the lowest index first among ties (a row with fewer
    positives takes the lowest-index fills);
  - :func:`multi_similarity_loss` (``MultiSimilarityLoss._forward_apn``,
    ``losses/multi_similarity_loss.py:25-47``): the dynamic negative filter
    as a multiplicative mask inside the log-sum-exp, summed with ``log1p``;
  - :func:`binary_focal_loss` and :func:`focal_loss`
    (``losses/focal_loss.py:5-64``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..nn.core import l2_normalize

_NEG_INF = -1e30


def cosine_affinity(embeddings: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity (losses/loss_utils.py compute_aff)."""
    e = l2_normalize(embeddings, dim=-1)
    return e @ e.T


def truncated_smooth_ap(
    embeddings: torch.Tensor,
    positives_mask: torch.Tensor,
    negatives_mask: torch.Tensor,
    tau1: float = 0.01,
    positives_per_query: int = 4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Recall@k surrogate loss over ``(N, D)`` embeddings with ``(N, N)``
    bool masks. Returns ``(loss, stats)``: ``loss``, ``ap``,
    ``positives_per_query``, ``recall_at_1``, ``avg_embedding_norm``."""
    n = embeddings.shape[0]
    top_k = min(positives_per_query, n)
    s_qz = cosine_affinity(embeddings)                                  # (N, N)
    pos_f, neg_f = positives_mask.to(s_qz.dtype), negatives_mask.to(s_qz.dtype)

    s_positives = torch.where(positives_mask, s_qz.detach(), _NEG_INF)
    # a stable descending sort: the lowest index first among ties, as lax.top_k
    closest_pos = torch.sort(s_positives, dim=1, descending=True, stable=True).indices[:, :top_k]

    # rank sigmoid on similarity differences, Eq. (2)
    s_at_pos = torch.gather(s_qz, 1, closest_pos)                       # (N, top_k)
    s_diff = s_qz[:, None, :] - s_at_pos[:, :, None]                    # (N, top_k, N)
    s_sig = torch.sigmoid(s_diff / tau1)

    # the positive itself is not ranked against itself
    self_mask = torch.nn.functional.one_hot(closest_pos, n).to(s_sig.dtype)
    r_p = (s_sig * pos_f[:, None, :] * (1.0 - self_mask)).sum(dim=2) + 1.0   # (N, top_k)
    r_omega = r_p + (s_sig * neg_f[:, None, :]).sum(dim=2)
    r = r_p / r_omega

    valid_pos = torch.gather(pos_f, 1, closest_pos)
    n_valid = valid_pos.sum(dim=1)
    q_valid = (n_valid > 0).to(r.dtype)
    per_q_ap = (r * valid_pos).sum(dim=1) / n_valid.clamp_min(1.0)
    ap = (per_q_ap * q_valid).sum() / q_valid.sum().clamp_min(1.0)
    loss = 1.0 - ap

    # recall@1 over the batch (the best positive's hard ranking)
    hard_rank = ((s_diff.detach()[:, 0, :] > 0) & negatives_mask).sum(dim=1)
    stats = {
        "loss": loss,
        "ap": ap,
        "positives_per_query": pos_f.sum(dim=1).mean(),
        "recall_at_1": (hard_rank <= 1).to(s_qz.dtype).mean(),
        "avg_embedding_norm": torch.linalg.vector_norm(embeddings, dim=1).mean(),
    }
    return loss, stats


def _cosine_sim_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of matching rows."""
    return (l2_normalize(a, -1) * l2_normalize(b, -1)).sum(dim=-1)


def multi_similarity_loss(
    a_feat: torch.Tensor,
    p_feat: torch.Tensor,
    n_feat: torch.Tensor,
    thresh: float = 0.5,
    margin: float = 0.3,
    scale_pos: float = 2.0,
    scale_neg: float = 40.0,
) -> torch.Tensor:
    """The 'apn' mode over ``(b, k, d)`` anchor, positive and negative rows
    (or ``(k, d)``, one group): per group the positive and the kept
    negative terms (a negative is kept when its similarity plus ``margin``
    exceeds the least positive similarity), the mean over the groups that
    keep a negative."""
    if a_feat.dim() == 2:
        a_feat, p_feat, n_feat = (x[None] for x in (a_feat, p_feat, n_feat))
    pos_sim = _cosine_sim_rows(a_feat, p_feat)             # (b, k)
    neg_sim = _cosine_sim_rows(a_feat, n_feat)             # (b, k)
    min_pos = pos_sim.amin(dim=1, keepdim=True)
    neg_keep = (neg_sim + margin > min_pos).to(pos_sim.dtype)
    pos_loss = (1.0 / scale_pos) * torch.log1p(torch.exp(-scale_pos * (pos_sim - thresh)).sum(dim=1))
    neg_loss = (1.0 / scale_neg) * torch.log1p((torch.exp(scale_neg * (neg_sim - thresh)) * neg_keep).sum(dim=1))
    has_neg = (neg_keep.sum(dim=1) > 0).to(pos_sim.dtype)
    return ((pos_loss + neg_loss) * has_neg).sum() / has_neg.sum().clamp_min(1.0)


def binary_focal_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    gamma: float = 2.0,
    alpha: float = 0.25,
    epsilon: float = 1e-9,
    with_logit: bool = False,
) -> torch.Tensor:
    """Binary focal loss, the mean over every element; ``logits`` are
    probabilities unless ``with_logit``."""
    p = torch.sigmoid(logits) if with_logit else logits
    t = target.to(p.dtype)
    loss = -alpha * t * (1 - p) ** gamma * torch.log(p + epsilon)
    loss = loss + -(1 - alpha) * (1 - t) * p ** gamma * torch.log(1 - p + epsilon)
    return loss.mean()


def focal_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    gamma: float = 2.0,
    alpha: float = 1.0,
    epsilon: float = 1e-9,
) -> torch.Tensor:
    """Multi-class focal loss over ``(N, C)`` logits and ``(N,)`` integer
    labels, class 0 ignored; the mean over rows of the sum over classes.
    A label outside ``[0, C)`` contributes nothing (``jax.nn.one_hot``)."""
    num_labels = logits.shape[-1]
    one_hot = (target[..., None] == torch.arange(num_labels, device=logits.device)).to(logits.dtype)
    one_hot[:, 0] = 0.0                                    # ignore index 0
    p = torch.softmax(logits, dim=-1)
    loss = -alpha * one_hot * (1 - p) ** gamma * torch.log(p + epsilon)
    return loss.sum(dim=1).mean()
