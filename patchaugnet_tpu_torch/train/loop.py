"""Epoch-level training / evaluation loops.

Port of ``patchaugnet_tpu/train/loop.py``, the rebuild of the reference
training script's ``train_one_epoch`` (train_place_recognition.py:192-416) and
``eval`` (:419-488):

  - batches come from PlaceRecognitionDataset.iter_epoch (faulty-tuple
    skipping included);
  - patch correspondence tables are built on the host per batch from
    overlap records and the centres of ``center_fn`` (the model's first
    FPS, run on the card and read back), then the step runs on the
    model's device;
  - hard-negative mining: after ``HARD_NEG_EPOCH`` (5), every
    ``1400 // batch_size`` batches the whole-train-set descriptors are
    refreshed and hard negatives re-mined (:401-406), the refresh through
    the eval forward, the mining on the dataset's device;
  - a per-epoch checkpoint named like the reference's .pth (:415,
    172-189) through ``train.save_checkpoint``.

``forward_fn`` takes clouds (``serving.build_forward_fn``: the forward
holds its model and runs it in eval mode). Random draws of the tables and
the mining come from the ``rng`` / ``np_rng`` the caller passes (the JAX
loop draws from the global ``random`` and ``np.random``).
"""
from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.overlap import build_correspondences
from ..data.tuple_dataset import PlaceRecognitionDataset, TupleBatch
from ..losses.patch_contrast import PatchCorrespondences
from .state import TrainState, save_checkpoint
from .step import empty_patch_inputs

HARD_NEG_EPOCH = 5
# Steps queued before a metric read (see train_one_epoch).
METRIC_FETCH_LAG = 3
HARD_NEG_EPOCH_FOR_PATCH_ALIGN = 10


def prepare_patch_inputs(
    batch: TupleBatch,
    center_fn: Callable,
    cfg: Dict[str, Any],
    epoch: int,
    rng: random.Random,
    np_rng: np.random.RandomState,
) -> Tuple[PatchCorrespondences, torch.Tensor]:
    """Correspondence tables + related-cloud mask for one batch, on the
    CPU (the step moves them). Reads the centres back from their device.
    ``center_fn`` takes ``batch.clouds`` and returns the whole batch's
    centres (a sharded one where the batch holds one rank's rows)."""
    total = batch.total
    if not batch.nn_dict:
        return empty_patch_inputs(cfg, total)
    centers = center_fn(batch.clouds).cpu().numpy()       # (B*T, M)
    use_hard = (
        epoch > HARD_NEG_EPOCH_FOR_PATCH_ALIGN
        and cfg.get("use_hard_negative_patch_mining", False)
    )
    corr = build_correspondences(
        batch.nn_dict,
        centers,
        max_rows=cfg.get("A2B_MAX_ROWS", 2048),
        max_pairs=cfg.get("A2B_MAX_PAIRS", 16),
        use_hard_negative_patches=use_hard,
        rng=rng,
        np_rng=np_rng,
    )
    mask = np.zeros((total,), bool)
    for (m, n) in batch.nn_dict:
        mask[m] = True
        mask[n] = True
    return corr, torch.from_numpy(mask)


def train_one_epoch(
    state: TrainState,
    train_step: Callable,
    train_ds: PlaceRecognitionDataset,
    cfg: Dict[str, Any],
    epoch: int,
    rng: random.Random,
    np_rng: np.random.RandomState,
    forward_fn: Optional[Callable] = None,
    center_fn: Optional[Callable] = None,
    writer=None,
    logger=None,
    total_iterations: int = 0,
    max_batches: Optional[int] = None,
    save_dir: Optional[str] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> Dict[str, Any]:
    """One epoch of ``train_step`` over ``train_ds``; returns the mean of
    each metric, ``batches``, ``patch_batches`` (batches with overlap
    tables), ``seconds``, ``total_iterations`` and ``state``.

    ``shard``: (this rank, the ranks) of a data-parallel run. Every rank
    draws the same batches and loads only its rows of each
    (``parallel.host_batch_slice``), as it does of each batch of the
    mining refresh; ``train_step``, ``center_fn`` and ``forward_fn`` then
    take those rows, and ``center_fn`` and ``forward_fn`` return the whole
    batch's outputs."""
    batch_size = cfg["TRAIN_BATCH_SIZE"]
    rows = refresh_rows = None
    refresh_batch = 36
    if shard is not None:
        from ..parallel.host_data import host_batch_slice

        tuple_size = 1 + cfg["TRAIN_POSITIVES_PER_QUERY"] + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 1
        rows = host_batch_slice(batch_size * tuple_size, *shard)
        refresh_batch = -(-refresh_batch // shard[1]) * shard[1]
        refresh_rows = host_batch_slice(refresh_batch, *shard)
    use_hard_neg = True
    if epoch <= HARD_NEG_EPOCH:
        train_ds.clear_global_descs()

    epoch_losses: Dict[str, list] = {}
    count = patch_batches = 0
    t_start = time.time()
    refresh_every = max(1400 // batch_size, 1)

    # Metric reads lag the queue by METRIC_FETCH_LAG steps, as in the JAX
    # loop: every recorded value is unchanged, only the time of the read
    # moves. On one CUDA stream the read's stack and copy still queue behind
    # the step just queued, so the host waits for that step here (PERF.md
    # section 5); reading without that wait is queued in ROADMAP.
    pending: list = []                                     # (iteration, metrics)

    def _drain(entry):
        it, m = entry
        keys = sorted(m)
        # one stacked copy instead of a read per metric
        vals = torch.stack([m[k] for k in keys]).cpu().numpy()
        md = dict(zip(keys, vals))
        for k, v in md.items():
            epoch_losses.setdefault(k, []).append(float(v))
        if writer is not None:
            writer.add_scalars(
                "iter_loss",
                {f"train_{k}": float(v) for k, v in md.items()},
                it,
            )

    for batch in train_ds.iter_epoch(batch_size, shuffle=True, rows=rows):
        if center_fn is not None and batch.nn_dict:
            corr, mask = prepare_patch_inputs(batch, center_fn, cfg, epoch, rng, np_rng)
            patch_batches += 1
        else:
            corr, mask = empty_patch_inputs(cfg, batch.total)
        state, metrics = train_step(state, batch.clouds, corr, mask)
        total_iterations += batch_size
        count += 1
        pending.append((total_iterations, metrics))
        if len(pending) > METRIC_FETCH_LAG:
            _drain(pending.pop(0))
        # hard-negative mining refresh once the model is robust enough
        if (
            use_hard_neg
            and epoch > HARD_NEG_EPOCH
            and forward_fn is not None
            and count % refresh_every == min(29, refresh_every - 1)
        ):
            train_ds.update_global_descs(forward_fn, batch_size=refresh_batch, rows=refresh_rows)
            train_ds.mine_hard_negatives(np_rng)
            if logger:
                logger.info("Updated cached descriptors for hard-negative mining")
        if max_batches is not None and count >= max_batches:
            break
    for entry in pending:
        _drain(entry)

    summary: Dict[str, Any] = {
        k: float(np.mean(v)) if v else 0.0 for k, v in epoch_losses.items()
    }
    summary["batches"] = count
    summary["patch_batches"] = patch_batches
    summary["seconds"] = time.time() - t_start
    summary["total_iterations"] = total_iterations
    if writer is not None:
        writer.add_scalars(
            "epoch_loss", {f"train_{k}": v for k, v in summary.items() if isinstance(v, float)}, epoch + 1
        )
    if save_dir is not None:
        save_checkpoint(save_dir, state, epoch, total_iterations)
    summary["state"] = state
    return summary


def evaluate(
    forward_fn: Callable,
    test_ds: PlaceRecognitionDataset,
    top_k: int = 25,
    batch_size: int = 36,
    logger=None,
    writer=None,
    epoch: int = 0,
    eval_name: str = "testing",
    save_model_type: Optional[str] = None,
) -> Dict[str, Any]:
    """Epoch eval: refresh descriptors, per-trip-pair recall, averages
    (reference eval(), train_place_recognition.py:419-488).

    ``save_model_type`` writes the per-record descriptor store in the
    reference layout (global + local when ``forward_fn`` returns the
    (global, local, center_idx) tuple, scene_dataset.py:687-708)."""
    stats = test_ds.update_global_descs(
        forward_fn,
        batch_size=batch_size,
        stat_time=True,
        save_model_type=save_model_type,
    )
    results = test_ds.get_recall_precision(top_k=top_k)
    recall_sum, precision_sum, count = None, None, 0
    one_percent, lost = [], []
    for (qt, rt), res in results.items():
        if qt == rt or res.num_evaluated == 0:
            continue
        if logger:
            logger.info(
                f"query {test_ds.scene.trip_names[qt]} vs db {test_ds.scene.trip_names[rt]}: "
                f"N_q={res.num_evaluated} N_db={res.num_database} "
                f"R@1={res.recall[0]:.2f} R@1%={res.one_percent_recall:.2f}"
            )
        recall_sum = res.recall if recall_sum is None else recall_sum + res.recall
        precision_sum = (
            res.precision if precision_sum is None else precision_sum + res.precision
        )
        count += 1
        one_percent.append(res.one_percent_recall)
        lost.append(res.lost)
    out: Dict[str, Any] = {"num_pairs": count, "desc_time": stats}
    if count:
        out["ave_recall"] = recall_sum / count
        out["ave_precision"] = precision_sum / count
        out["ave_one_percent_recall"] = float(np.mean(one_percent))
        out["recall_at_1"] = float(out["ave_recall"][0])
        out["lost_sum"] = int(np.sum(lost))
        if logger:
            logger.info(f"Average Recall @1: {out['recall_at_1']:.2f}")
            logger.info(f"Average Recall @1%: {out['ave_one_percent_recall']:.2f}")
        if writer is not None:
            writer.add_scalars(
                "ave_recall@topN",
                {
                    f"top1_{eval_name}": out["recall_at_1"],
                    f"top1pct_{eval_name}": out["ave_one_percent_recall"],
                },
                epoch + 1,
            )
    return out
