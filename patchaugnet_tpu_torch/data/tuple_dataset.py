"""Tuple-batch dataset facade.

Port of ``patchaugnet_tpu/data/tuple_dataset.py``, the rebuild of the
reference's ``datasets/place_recognition_dataset.py``
(PlaceRecognitionDataSet): samples (query, positives, negatives,
other_neg) tuples from a :class:`SceneDataset`, applies rotate/jitter
augmentation, and assembles the **flattened static-shape batch** the
models consume — the reference's `run_model` concat + view
(train_place_recognition.py:142-151) done host-side once per batch.

Faulty tuples (insufficient pos/neg or no other_neg) cause the whole
batch to be skipped, exactly like train_place_recognition.py:223-256.

Note on augmentation: the reference constructs its training dataset
without ``data_augmentation`` (train_place_recognition.py:499-506), so
its rotate/jitter path — which *doubles* the tuple via vstack
(place_recognition_dataset.py:93-137) — never runs in the shipped
training. Here ``augmentation`` applies in-place (replace) by default;
the doubling semantics are intentionally not reproduced.
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .overlap import OverlapEntry, load_overlap_pb, synthetic_overlaps
from .pointclouds import jitter_point_cloud, rotate_point_cloud
from .scene_dataset import SceneDataset


@dataclass
class TupleBatch:
    """One flattened training batch.

    clouds: ``(B * tuple_size, N, 3)`` float32 — order per tuple is
    [query, positives..., negatives..., other_neg], tuples concatenated
    (matches run_model's view, train_place_recognition.py:148-149); with
    ``rows`` set, only those rows of it. ``total`` is the flattened
    batch's cloud count.
    """

    clouds: np.ndarray
    batch_size: int
    num_pos: int
    num_neg: int
    query_indices: List[int]
    nn_dict: Dict[Tuple[int, int], List[OverlapEntry]]
    rows: Optional[slice] = None
    total: int = -1

    def __post_init__(self):
        if self.total < 0:
            self.total = self.clouds.shape[0]

    @property
    def tuple_size(self) -> int:
        return 1 + self.num_pos + self.num_neg + 1

    def split_descs(self, descs: np.ndarray):
        """(B*T, D) -> (queries (B,1,D), pos (B,P,D), neg (B,N,D),
        other (B,1,D))."""
        b, t = self.batch_size, self.tuple_size
        d = descs.reshape(b, t, -1)
        p, n = self.num_pos, self.num_neg
        return (
            d[:, :1],
            d[:, 1 : 1 + p],
            d[:, 1 + p : 1 + p + n],
            d[:, 1 + p + n :],
        )


class PlaceRecognitionDataset:
    """Batch sampler over a scene (train) / evaluation facade (test).

    ``seed`` seeds the tuple sampler (``random.Random``) and the draws of
    the augmentation and the synthetic overlaps (``np.random.RandomState``);
    ``device`` is where the scene's retrieval engine runs.
    """

    def __init__(
        self,
        name: str,
        for_training: bool,
        num_pos: int = 2,
        num_neg: int = 14,
        other_neg: bool = True,
        augmentation: Optional[Sequence[str]] = None,
        num_hard_neg: int = 10,
        num_sample_neg: int = 3000,
        load_overlap_indices: bool = False,
        seed: int = 0,
        num_points: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.scene = SceneDataset(name, for_training, device=device)
        if num_points is not None:
            self.scene.num_points = num_points
        if not self.scene.load():
            raise FileNotFoundError(
                f"dataset pickles not found under {self.scene.pickle_dir()}; "
                f"run dataset creation first"
            )
        self.num_pos = num_pos
        self.num_neg = num_neg
        self.other_neg = other_neg
        self.augmentation = list(augmentation or [])
        self.num_hard_neg = num_hard_neg
        self.num_sample_neg = num_sample_neg
        self.load_overlap_indices = load_overlap_indices
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.scene.records)

    # ------------------------------------------------------- batching
    def sample_batch(self, query_indices: Sequence[int], rows: Optional[slice] = None) -> Optional[TupleBatch]:
        """The batch of these queries' tuples. ``rows``: load only those
        rows of the flattened batch (a data-parallel rank's); every tuple is
        drawn all the same, so the draws and ``nn_dict`` are the whole
        batch's."""
        if rows is not None and self.augmentation:
            raise ValueError("augmentation draws for the whole batch's clouds: sample it whole (rows=None)")
        tuples = []
        for q in query_indices:
            t = self.scene.get_training_tuple(
                q, self.num_pos, self.num_neg, self.other_neg, rng=self.rng, load=rows is None
            )
            if t is None:
                return None                                # skip faulty batch
            tuples.append(t)
        if rows is None:
            clouds = np.concatenate([t["clouds"] for t in tuples])  # (B*T, N, 3)
            total = clouds.shape[0]
        else:
            flat = [i for t in tuples for part in t["indices"] for i in part]
            clouds, _ = self.scene.get_clouds(flat[rows])
            total = len(flat)
        if self.augmentation:
            clouds = self._augment(clouds)
        nn_dict: Dict[Tuple[int, int], List[OverlapEntry]] = {}
        if self.load_overlap_indices:
            nn_dict = self._batch_overlaps(tuples)
        return TupleBatch(
            clouds=clouds.astype(np.float32),
            batch_size=len(tuples),
            num_pos=self.num_pos,
            num_neg=self.num_neg,
            query_indices=[t["indices"][0][0] for t in tuples],
            nn_dict=nn_dict,
            rows=rows,
            total=total,
        )

    def _augment(self, clouds: np.ndarray) -> np.ndarray:
        aug = self.augmentation
        if "random" in aug:
            aug = ["rotate"] if self.np_rng.randint(2) == 0 else ["jitter"]
        if "rotate" in aug:
            clouds, _ = rotate_point_cloud(clouds, None, rng=self.np_rng)
        if "jitter" in aug:
            clouds = jitter_point_cloud(clouds, rng=self.np_rng)
        return clouds

    def _batch_overlaps(self, tuples) -> Dict[Tuple[int, int], List[OverlapEntry]]:
        """Overlap entries keyed by flattened-batch cloud positions
        (the j*tuple_size shift at train_place_recognition.py:258-265)."""
        nn_dict: Dict[Tuple[int, int], List[OverlapEntry]] = {}
        tuple_size = 1 + self.num_pos + self.num_neg + 1
        for j, t in enumerate(tuples):
            q_idx = t["indices"][0][0]
            pos_indices = t["indices"][1]
            per_pos = self._overlaps_for(q_idx, pos_indices)
            if per_pos is None:
                continue
            for i, entries in per_pos.items():
                # query at tuple slot 0, positive i at slot 1+i
                nn_dict[j * tuple_size + 0, j * tuple_size + 1 + i] = entries
        return nn_dict

    def _overlaps_for(self, q_idx: int, pos_indices: List[int]):
        """Reference semantics (scene_dataset.get_overlap_indices,
        :278-297): load the per-query .pb; synthetic scenes derive
        overlaps from geometry instead."""
        if self.scene.name == "synthetic":
            out = {}
            q_cloud = self.scene._clouds[q_idx]
            for i, p in enumerate(pos_indices):
                out[i] = synthetic_overlaps(
                    q_cloud, self.scene._clouds[p], rng=self.np_rng
                )
            return out
        pb = os.path.join(
            self.scene.pickle_dir(),
            f"{self.scene.dataset_type}_overlap_indices_{q_idx}.pb",
        )
        if not os.path.exists(pb):
            return None
        per_positive = load_overlap_pb(pb)
        return {
            i: per_positive[p]
            for i, p in enumerate(pos_indices)
            if p in per_positive
        }

    def iter_epoch(
        self, batch_size: int, shuffle: bool = True, rows: Optional[slice] = None
    ) -> Iterator[TupleBatch]:
        """The epoch's batches; ``rows`` as :meth:`sample_batch`."""
        order = list(range(len(self)))
        if shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            batch = self.sample_batch(order[s : s + batch_size], rows)
            if batch is not None:
                yield batch

    # ------------------------------------------------------ delegation
    def update_global_descs(
        self, forward_fn, batch_size: int = 100, stat_time=False,
        save_model_type=None, rows: Optional[slice] = None,
    ):
        return self.scene.make_descs(
            forward_fn, batch_size, stat_time, save_model_type=save_model_type, rows=rows
        )

    def clear_global_descs(self):
        self.scene.clear_global_descs()

    def mine_hard_negatives(self, rng: np.random.RandomState):
        """``rng`` draws the candidates of a query with more than
        ``num_sample_neg`` negatives (the JAX package: the global
        ``np.random``)."""
        self.scene.mine_hard_negatives(self.num_hard_neg, self.num_sample_neg, rng=rng)

    def get_recall_precision(self, top_k: int = 25, collect_query_results=False):
        return self.scene.recall_precision_all(top_k, collect_query_results)

    def find_and_save_top(
        self,
        model_type: Optional[str] = None,
        top_k: int = 300,
        space_type: str = "feature",
        save: bool = False,
    ):
        """Top-k dump in feature or euclidean space (the reference
        facade, place_recognition_dataset.py:45-51)."""
        if space_type in ("feature", "feat"):
            return self.scene.find_top_k_feat(model_type, top_k, save=save)
        if space_type == "euc":
            return self.scene.find_top_k_euc(top_k, save=save)
        raise ValueError(f"space_type {space_type}")
