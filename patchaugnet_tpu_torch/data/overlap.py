"""Patch-overlap correspondences: .pb IO and padded table construction.

Port of ``patchaugnet_tpu/data/overlap.py``, the reference's host-side
a2b matching pipeline:
  - per-query .pb files of ``QueryOverlapIndices``
    (scene_dataset.py:278-297, schema datasets/query_pos_neg_dataset.proto)
    read and written by :mod:`.wire`, the protobuf wire format in plain
    Python (no protobuf runtime; the same bytes as protobuf's);
  - geometry-derived overlap entries for the synthetic scene, on
    ``scipy.spatial.cKDTree`` (both it and sklearn's ``KDTree`` take the
    points at distance ``<= r``; scipy returns them sorted);
  - the per-pair numpy matching of overlap records against model centre
    indices (train_place_recognition.py:326-363) becomes
    :func:`build_correspondences`, emitting the fixed-size padded
    :class:`~patchaugnet_tpu_torch.losses.PatchCorrespondences` that the
    train step takes, as CPU tensors (the step moves them to its device).

Centre indices come from the same deterministic FPS the model runs at
its first SA level (``train.build_center_fn``), so the tables match the
forward's patch slots. Random draws come from the generators the caller
passes (the JAX package draws from the global ``random`` and
``np.random``: seeding those and passing ``random.Random(seed)`` and
``np.random.RandomState(seed)`` here gives the same draws).
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..losses.patch_contrast import PatchCorrespondences
from . import wire


class OverlapEntry:
    """One ``Uint32Pair``: a query-cloud point and its near/far matches
    in a positive cloud (all indices in original-cloud space)."""

    __slots__ = ("idx1", "near_indices2", "far_indices2", "bad_far_indices2")

    def __init__(self, idx1=0, near=(), far=(), bad_far=()):
        self.idx1 = int(idx1)
        self.near_indices2 = list(near)
        self.far_indices2 = list(far)
        self.bad_far_indices2 = list(bad_far)


def load_overlap_pb(path: str) -> Dict[int, List[OverlapEntry]]:
    """Read a reference-format per-query .pb: positive_idx -> entries
    (``inv_overlap_indices`` and unknown fields skipped; a positive
    written twice keeps its last record, as the JAX package's reader)."""
    with open(path, "rb") as f:
        _, positives = wire.decode_query_overlap(f.read())
    return {pos_idx: [OverlapEntry(*pair) for pair in pairs] for pos_idx, pairs in positives}


def save_overlap_pb(path: str, per_positive: Dict[int, List[OverlapEntry]], query_idx: int = 0) -> None:
    """Write the .pb that protobuf's ``SerializeToString`` writes for the
    same records (a value outside uint32 raises ``ValueError``)."""
    data = wire.encode_query_overlap(query_idx, (
        (pos_idx, [(e.idx1, e.near_indices2, e.far_indices2, e.bad_far_indices2) for e in entries])
        for pos_idx, entries in per_positive.items()))
    with open(path, "wb") as f:
        f.write(data)


def synthetic_overlaps(
    query_cloud: np.ndarray,
    pos_cloud: np.ndarray,
    n_entries: int = 128,
    r_near: float = 0.1,
    r_far: float = 0.5,
    *,
    rng: np.random.RandomState,
) -> List[OverlapEntry]:
    """Geometry-derived overlap entries for clouds with known overlap
    (synthetic scene / tests). near = positive points within ``r_near``
    of the query point; far = a sample beyond ``r_far``."""
    from scipy.spatial import cKDTree   # imported here: scipy.spatial takes a second

    tree = cKDTree(pos_cloud)
    picks = rng.choice(len(query_cloud), size=min(n_entries, len(query_cloud)), replace=False)
    near_all = tree.query_ball_point(query_cloud[picks], r=r_near, return_sorted=True)
    wide_all = tree.query_ball_point(query_cloud[picks], r=r_far, return_sorted=True)
    entries = []
    for i, near, near_wide in zip(picks, near_all, wide_all):
        if len(near) == 0:
            continue
        far_mask = np.ones(len(pos_cloud), bool)
        far_mask[near_wide] = False
        far = np.where(far_mask)[0]
        if len(far) == 0:
            continue
        far = rng.choice(far, size=min(32, len(far)), replace=False)
        entries.append(
            OverlapEntry(i, list(near), far[: len(far) // 2].tolist(), far[len(far) // 2 :].tolist())
        )
    return entries


def build_correspondences(
    nn_dict: Dict[Tuple[int, int], List[OverlapEntry]],
    center_indices: np.ndarray,
    max_rows: int,
    max_pairs: int,
    use_hard_negative_patches: bool = False,
    max_entries_per_pair: int = 500,
    *,
    rng: random.Random,
    np_rng: np.random.RandomState,
    emulate_reference_far_sampling: bool = True,
) -> PatchCorrespondences:
    """Padded correspondence tables from overlap records, as CPU tensors.

    Args:
      nn_dict: (query_cloud_pos_in_batch, pos_cloud_pos_in_batch) ->
        overlap entries, cloud positions in the *flattened* tuple batch
        (the stacking at train_place_recognition.py:258-265).
      center_indices: ``(B, M)`` original-cloud indices of each cloud's
        level-1 patch centres (host-side FPS, identical to the model's).
      max_rows / max_pairs: static table sizes.
      rng: draws the entries of a pair that has more than
        ``max_entries_per_pair``; ``np_rng`` draws each row's negative.
      use_hard_negative_patches: after the warm-up epoch the reference
        draws negatives only from ``bad_far_indices2``
        (train_place_recognition.py:345-347).
      emulate_reference_far_sampling: the reference's else-branch
        *overwrites* ``list_far_indices`` with a scalar every second
        element, so only the last even-positioned far index survives
        (train_place_recognition.py:349-355) — replicated faithfully by
        default; set False for the evident intent (every 2nd element).
    """
    rows: List[Tuple[int, int, int, int, int, int]] = []
    pair_list = list(nn_dict.items())[:max_pairs]
    for pair_id, ((m, n), entries) in enumerate(pair_list):
        m_centers = center_indices[m]
        n_centers = center_indices[n]
        k_list = list(range(len(entries)))
        if len(k_list) > max_entries_per_pair:
            k_list = rng.sample(k_list, max_entries_per_pair)
        for k in k_list:
            e = entries[k]
            idx1 = np.where(m_centers == e.idx1)[0]
            if len(idx1) == 0:
                continue
            pos_idx2 = np.where(np.isin(n_centers, e.near_indices2))[0]
            if len(pos_idx2) == 0:
                continue
            if use_hard_negative_patches:
                far_list: Sequence[int] = e.bad_far_indices2
            else:
                temp = list(e.far_indices2) + list(e.bad_far_indices2)
                if emulate_reference_far_sampling:
                    far_list = []
                    for far_i in range(0, len(temp), 2):
                        far_list = temp[far_i]          # reference scalar overwrite
                    far_list = [far_list] if far_list != [] else []
                else:
                    far_list = temp[::2]
            neg_idx2 = np.where(np.isin(n_centers, far_list))[0]
            if len(neg_idx2) == 0:
                continue
            neg_pick = np_rng.choice(neg_idx2, len(pos_idx2), replace=True)
            for p, ng in zip(pos_idx2, neg_pick):
                rows.append((m, n, int(idx1[0]), int(p), int(ng), pair_id))
    rows = rows[:max_rows]
    arr = np.zeros((max_rows, 6), np.int32)
    valid = np.zeros((max_rows,), bool)
    if rows:
        arr[: len(rows)] = rows
        valid[: len(rows)] = True
    return PatchCorrespondences(*(torch.from_numpy(arr[:, c].copy()) for c in range(6)),
                                torch.from_numpy(valid), max_pairs)
