"""Patch feature-contrast (a2b) loss over padded correspondence tables.

Port of ``patchaugnet_tpu/losses/patch_contrast.py``. The host builds
fixed-size correspondence tables once per batch, and the loss is a
gather and a segment mean over the table's pairs:

  per pair p:   L_p = mean_rows ||q - pos||^2
                    + mean_rows max(margin - ||q - neg||, 0)^2
  total       = sum_p L_p / #valid_pairs

which reproduces ``contrastive_loss`` (reference
``losses/pointnetvlad_loss.py:170-186``) and the equal-weight pair
averaging of its train loop (``train_place_recognition.py:380-384``).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch


class PatchCorrespondences(NamedTuple):
    """Padded correspondence rows for one tuple batch.

    Every table is ``(T,)``; ``row_valid`` masks the padding. Rows are
    grouped by ``row_pair_id`` in ``[0, num_pairs)`` (a precondition: the
    segment sums index with it); pairs with no valid row drop out of the
    average.
    """

    row_q_cloud: torch.Tensor   # (T,) int32: cloud of the query patch
    row_n_cloud: torch.Tensor   # (T,) int32: cloud of the positive and negative patches
    row_q_idx: torch.Tensor     # (T,) int32: query patch slot in [0, M)
    row_pos_idx: torch.Tensor   # (T,) int32: positive patch slot
    row_neg_idx: torch.Tensor   # (T,) int32: negative patch slot
    row_pair_id: torch.Tensor   # (T,) int32: owning (query, positive) cloud pair
    row_valid: torch.Tensor     # (T,) bool
    num_pairs: int              # upper bound on the pair count

    @staticmethod
    def empty(max_rows: int, num_pairs: int) -> "PatchCorrespondences":
        z = torch.zeros((max_rows,), dtype=torch.int32)
        return PatchCorrespondences(z, z, z, z, z, z, torch.zeros((max_rows,), dtype=torch.bool), num_pairs)

    def to(self, device: Union[str, torch.device]) -> "PatchCorrespondences":
        return PatchCorrespondences(*(t.to(device) for t in self[:7]), self.num_pairs)


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    return torch.zeros((num,), dtype=values.dtype, device=values.device).index_add(0, seg, values)


def patch_contrastive_loss(
    patch_features: torch.Tensor, corr: PatchCorrespondences, margin: float
) -> torch.Tensor:
    """a2b contrast over padded correspondences.

    Args:
      patch_features: ``(B, M, D)`` L2-normalised patch features
        (PatchAugNet ``patch_data.patch_features``).
      corr: padded correspondence tables, cloud ids indexing ``B``.
      margin: MARGIN_1 of the config.

    Returns the scalar loss (0 when no pair has a valid row).
    """
    valid = corr.row_valid.to(patch_features.dtype)         # (T,)
    q = patch_features[corr.row_q_cloud.long(), corr.row_q_idx.long()]   # (T, D)
    p = patch_features[corr.row_n_cloud.long(), corr.row_pos_idx.long()]
    n = patch_features[corr.row_n_cloud.long(), corr.row_neg_idx.long()]

    qp = ((q - p) ** 2).sum(dim=-1)                         # (T,)
    # torch F.pairwise_distance adds eps=1e-6 inside the norm; the 1e-12
    # under the sqrt keeps the gradient finite at zero distance instead
    qn = torch.sqrt(((q - n) ** 2).sum(dim=-1) + 1e-12)
    qn = torch.clamp_min(margin - qn, 0.0) ** 2

    seg = corr.row_pair_id.long()
    cnt = _segment_sum(valid, seg, corr.num_pairs)          # (P,)
    qp_mean = _segment_sum(qp * valid, seg, corr.num_pairs) / torch.clamp_min(cnt, 1.0)
    qn_mean = _segment_sum(qn * valid, seg, corr.num_pairs) / torch.clamp_min(cnt, 1.0)
    pair_valid = (cnt > 0).to(patch_features.dtype)
    pair_loss = (qp_mean + qn_mean) * pair_valid
    return pair_loss.sum() / torch.clamp_min(pair_valid.sum(), 1.0)


def contrastive_loss(
    q_vec: torch.Tensor, pos_vec: torch.Tensor, neg_vec: torch.Tensor, margin: float
) -> torch.Tensor:
    """``contrastive_loss`` (pointnetvlad_loss.py:170-186) on stacked
    ``(M, D)`` rows with no padding: the oracle of
    :func:`patch_contrastive_loss`."""
    total = 0.0
    if pos_vec.shape[0] > 0:
        d = torch.sqrt(((q_vec - pos_vec) ** 2).sum(dim=-1) + 1e-12)
        total = total + (d ** 2).mean()
    if neg_vec.shape[0] > 0:
        d = torch.sqrt(((q_vec - neg_vec) ** 2).sum(dim=-1) + 1e-12)
        total = total + (torch.clamp_min(margin - d, 0.0) ** 2).mean()
    return total
