"""TruncatedSmoothAP, the MinkLoc3Dv2 training loss.

Port of ``cosine_affinity`` and ``truncated_smooth_ap`` of
``patchaugnet_tpu/losses/extra.py`` (reference
``losses/truncated_smoothap.py:11-107``): the reference's dynamic row
filtering as masked means. The positives a query ranks against are its
``positives_per_query`` most similar ones, picked as ``lax.top_k`` picks
them, the lowest index first among ties (a row with fewer positives
takes the lowest-index fills). The multi-similarity and focal losses of
that module are not ported (ROADMAP A9).
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
