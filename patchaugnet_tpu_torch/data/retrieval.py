"""Retrieval / recall engine.

Port of ``patchaugnet_tpu/data/retrieval.py``, the replacement for the
sklearn-KDTree retrieval paths of the reference data engine:
  - neighbour search over the descriptor database
    (``scene_dataset.get_recall_precision``, scene_dataset.py:1016-1099;
    ``find_top_k_feat``, :868-975; hard-negative mining, :1101-1113) is
    one batched ``Q @ DB^T`` (``torch.matmul``) and ``torch.topk`` on the
    given device, the card by default;
  - the recall/precision bookkeeping keeps the reference's exact
    semantics (skip-self ``continue`` without advancing the rank slot,
    add_one_more leading-self skip, 1%% threshold ``max(round(DB/100),1)``,
    cumulative-sum recall) in numpy over the top-k index matrix.

Distances are the JAX package's, in f32: ``max(q^2 + d^2 - 2 q.d, 0)``
(the masked form of hard-negative mining leaves out the clamp, as there),
with TF32 off on the card (``serving.resolve_device``). Ties go to the
lowest database index, as ``lax.top_k`` breaks them: ``torch.topk`` on
CUDA promises no order among equal values, so the top-k runs on int64
keys that hold the distance's order in their high word and the column in
their low word, and no two keys are equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..serving import resolve_device

Device = Union[str, torch.device]


def _ordered_keys(dist: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (distance, column): the f32 bits mapped to
    an order-preserving int32 (negative values with their magnitude bits
    flipped; -0.0 first made +0.0, so that it ties with 0.0 as in a float
    compare) in the high word, the column in the low word."""
    bits = (dist + 0.0).view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    cols = torch.arange(dist.shape[-1], device=dist.device, dtype=torch.int64)
    return (ordered.to(torch.int64) << 32) | cols


def _smallest(dist: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest per row, ascending, ties to the lowest column:
    ``(values, columns)``."""
    _, cols = torch.topk(_ordered_keys(dist), k, dim=-1, largest=False, sorted=True)
    return torch.gather(dist, -1, cols), cols


def _sqdist(queries: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """``q^2 + d^2 - 2 q.d`` in f32, the JAX package's order of operations."""
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    d2 = torch.sum(database * database, dim=-1, keepdim=True)
    return q2 + d2.T - 2.0 * torch.matmul(queries, database.T)


def topk_neighbors(
    queries: np.ndarray,
    database: np.ndarray,
    k: int,
    chunk: int = 4096,
    device: Device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest database rows per query (ascending squared L2 distance),
    as numpy ``(dists, idxs)``; the query axis runs in chunks."""
    dev = resolve_device(device)
    queries = np.asarray(queries, np.float32)
    db = torch.as_tensor(np.asarray(database, np.float32), device=dev)
    k = min(k, db.shape[0])
    dists, idxs = [], []
    for s in range(0, queries.shape[0], chunk):
        q = torch.as_tensor(queries[s : s + chunk], device=dev)
        d, i = _smallest(torch.clamp_min(_sqdist(q, db), 0.0), k)
        dists.append(d.cpu().numpy())
        idxs.append(i.to(torch.int32).cpu().numpy())
    return np.concatenate(dists), np.concatenate(idxs)


@dataclass
class RecallResult:
    """One (query_trip, ref_trip) evaluation block — the tuple the
    reference returns at scene_dataset.py:1095-1099."""

    recall: np.ndarray                 # (top_k,) cumulative %
    precision: np.ndarray              # (top_k,) %
    one_percent_recall: float
    lost: int                          # num_evaluated - one_percent_retrieved
    threshold: int                     # the "1%" neighbour count
    query_results: List[Dict] = field(default_factory=list)
    num_evaluated: int = 0
    num_database: int = 0


def recall_precision(
    query_descs: np.ndarray,
    database_descs: np.ndarray,
    database_indices: Sequence[int],
    query_indices: Sequence[int],
    true_positives: Dict[int, Set[int]],
    top_k: int = 25,
    add_one_more: bool = False,
    collect_query_results: bool = False,
    device: Device = "cuda",
) -> RecallResult:
    """Recall@1..top_k / Recall@1% / Precision@1..top_k.

    Args:
      query_descs: ``(Q, D)`` query descriptors (dataset order of
        ``query_indices``).
      database_descs: ``(M, D)`` database descriptors.
      database_indices: dataset-global index of each database row.
      query_indices: dataset-global index of each query row.
      true_positives: dataset-global query idx -> set of positive
        dataset-global indices. Queries with no positives are skipped
        (scene_dataset.py:1045-1046).
      add_one_more: query set is part of the database — fetch one extra
        neighbour and drop the leading self-match (scene_dataset.py:1038,
        1053-1056).
      device: where the neighbour search runs.
    """
    num_db = len(database_indices)
    threshold = max(int(round(num_db / 100.0)), 1)
    real_top_k = max(top_k + 1, threshold + 1)
    real_top_k = min(real_top_k, num_db)

    _, nbr = topk_neighbors(query_descs, database_descs, real_top_k, device=device)
    db_idx = np.asarray(database_indices)
    search = db_idx[nbr]                                    # (Q, real_top_k)

    recall = np.zeros(top_k)
    precision = np.zeros(top_k)
    one_percent_retrieved = 0
    num_evaluated = 0
    query_results: List[Dict] = []

    for qi, q_global in enumerate(query_indices):
        positives = true_positives.get(q_global, set())
        if not positives:
            continue
        num_evaluated += 1
        found = search[qi, 1:] if add_one_more else search[qi]
        found_positive = False
        for j in range(min(len(found), top_k)):
            fj = int(found[j])
            if fj == q_global:
                continue                                   # skip-self keeps slot j
            if fj in positives:
                if not found_positive:
                    recall[j] += 1
                    found_positive = True
                precision[j] += 1
        state = 2
        if set(int(x) for x in found[:threshold]) & positives:
            one_percent_retrieved += 1
            state = 1
        if collect_query_results:
            topn = [int(found[j]) for j in range(min(5, len(found)))]
            states = [t in positives for t in topn]
            if states and states[0]:
                state = 0
            query_results.append(
                {"query": int(q_global), "state": state,
                 "topN": topn, "topN_states": states}
            )

    one_percent_recall = 0.0
    if num_evaluated > 0:
        one_percent_recall = one_percent_retrieved / float(num_evaluated) * 100
        recall = np.cumsum(recall) / float(num_evaluated) * 100
        precision = (
            np.cumsum(precision) / float(num_evaluated) * 100
            / np.arange(1, top_k + 1)
        )
    return RecallResult(
        recall=recall,
        precision=precision,
        one_percent_recall=one_percent_recall,
        lost=num_evaluated - one_percent_retrieved,
        threshold=threshold,
        query_results=query_results,
        num_evaluated=num_evaluated,
        num_database=num_db,
    )


def hard_negatives(
    query_desc: np.ndarray,
    all_descs: np.ndarray,
    negative_indices: Sequence[int],
    num_hard_neg: int = 10,
    device: Device = "cuda",
) -> List[int]:
    """Nearest negatives in descriptor space (scene_dataset.py:1101-1113).

    Returns [] when fewer than ``num_hard_neg`` candidates exist, like
    the reference.
    """
    if len(negative_indices) < num_hard_neg:
        return []
    cand = np.asarray(all_descs)[np.asarray(negative_indices)]
    _, idx = topk_neighbors(query_desc[None], cand, num_hard_neg, device=device)
    return np.asarray(negative_indices)[idx[0]].tolist()


def hard_negatives_batch(
    query_descs: np.ndarray,
    all_descs: np.ndarray,
    negative_indices_list: Sequence[Sequence[int]],
    num_hard_neg: int = 10,
    chunk: int = 1024,
    device: Device = "cuda",
) -> List[List[int]]:
    """Hard-negative mining for many queries in fixed-shape sweeps.

    Each query's candidate set is a row of a boolean column mask over the
    full descriptor matrix (built on the host), and ``ceil(Q/chunk)``
    sweeps of one matmul and a masked top-k mine every query: the JAX
    package's ``hard_negatives_batch``. Queries with fewer than
    ``num_hard_neg`` candidates yield ``[]`` (the reference's rule), all
    others the k nearest of their candidates, ties to the lowest index.
    """
    dev = resolve_device(device)
    all_d = np.asarray(all_descs, np.float32)
    qd = np.asarray(query_descs, np.float32)
    n_q, r = qd.shape[0], all_d.shape[0]
    k = min(num_hard_neg, r)
    db = torch.as_tensor(all_d, device=dev)
    out: List[List[int]] = []
    for s in range(0, n_q, chunk):
        e = min(s + chunk, n_q)
        c = e - s
        mask = np.zeros((chunk, r), bool)
        for i in range(c):
            negs = negative_indices_list[s + i]
            if len(negs) >= num_hard_neg:
                mask[i, np.asarray(negs, np.int64)] = True
        qc = np.zeros((chunk, qd.shape[1]), np.float32)
        qc[:c] = qd[s:e]
        q = torch.as_tensor(qc, device=dev)
        dist = torch.where(torch.as_tensor(mask, device=dev), _sqdist(q, db), torch.inf)
        _, idx = _smallest(dist, k)
        idx = idx.cpu().numpy()
        for i in range(c):
            negs = negative_indices_list[s + i]
            out.append(idx[i, :k].tolist() if len(negs) >= num_hard_neg else [])
    return out
