#!/usr/bin/env python3
"""Recall-lift evidence per model family for the PyTorch/CUDA port:
each family trained at full width (4096-point clouds) on the
noise-hardened synthetic scene, recall@1 before and after.

    python bench_quality_torch.py [--model_type X] [--precision bfloat16] [--platform cpu]

It runs on the card unless ``--platform cpu`` is given. Families and
settings are those of the JAX package's ``bench_quality.py``:

  patch_aug_net  quadruplet + patch losses (a2a chamfer, a2b contrast),
                 hard-negative patch mining from epoch 11;
  pptnet         4-level SA backbone + grouped attention + 4-scale
                 SPVLAD, hardened harder (noise scale 0.9);
  pointnet_vlad  STN + conv stack + NetVLAD loupe head.

Each run: 2 tuples of 1 + 2 + 6 + 1 clouds per step, Adam at 5e-4 with
the step decay counted at 24 steps per epoch (so it fires at epoch 10),
12 epochs of 24 steps, recall@1 on the test split (top 5, batches of
12) before and after. The scene is 2 trips x 24 submaps, each cloud
hardened by ``np.random.RandomState(7)`` noise, the same realisation on
both splits. It prints the init recall, one line per epoch, the trained
recall, and as its last line one JSON object: family, precision, recall@1
before and after, the per-epoch totals, ms per step (the host's clock
over the epochs: batch assembly, tables and the step) and seconds.
``run(...)`` does the work; ``overrides`` shrinks a config for a CPU run.
"""
import argparse
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from patchaugnet_tpu_torch import configs  # noqa: E402  (plain dicts)

EPOCHS = 12
STEPS_PER_EPOCH = 24          # 48 queries / 2 tuples: the step decay fires at epoch 10
N_TRIPS, N_PER_TRIP = 2, 24
NOISE_SEED = 7
SEED = 0                      # the initial weights and the host's draws
EVAL_TOP_K, EVAL_BATCH = 5, 12

COMMON = dict(
    TRAIN_BATCH_SIZE=2, TRAIN_POSITIVES_PER_QUERY=2,
    TRAIN_NEGATIVES_PER_QUERY=6,
    BASE_LEARNING_RATE=5e-4, MOMENTUM=0.9, OPTIMIZER="adam",
    MAX_EPOCH=12, LEARNING_RATE_DECAY="step", MARGIN_1=0.5, MARGIN_2=0.2,
    LOSS_FUNCTION="quadruplet", LOSS_LAZY=True,
    TRIPLET_USE_BEST_POSITIVES=False, LOSS_IGNORE_ZERO_BATCH=False,
)


# scale: PPT-Net's multi-scale features give a high random-init recall at
# mild noise, so its scene is hardened harder
FAMILIES = {
    "patch_aug_net": dict(
        cfg=dict(
            configs.PATCH_AUG_NET, **COMMON,
            A2B_MAX_ROWS=2048, A2B_MAX_PAIRS=16,
            use_hard_negative_patch_mining=True,
        ),
        with_center=True, scale=0.35,
    ),
    "pptnet": dict(
        cfg=dict(
            COMMON,
            model_type="pptnet", NUM_POINTS=4096, GROUP=8,
            AGGREGATION="spvlad", FEATURE_OUTPUT_DIM=256,
            FEATURE_SIZE=[256, 256, 256, 256],
            MAX_SAMPLES=[64, 256, 1024, 4096],
            CLUSTER_SIZE=[1, 4, 16, 64],
            OUTPUT_DIM=[256, 256, 256, 256], GATING=True,
            SAMPLING=[1024, 256, 64, 16], KNN=[20, 20, 20, 20],
            use_patch_recon=False, use_patch_feature_contrast=False,
            use_hard_negative_patch_mining=False,
        ),
        with_center=False, scale=0.9,
    ),
    "pointnet_vlad": dict(
        cfg=dict(
            COMMON,
            model_type="pointnet_vlad", NUM_POINTS=4096,
            GLOBAL_FEAT=True, FEATURE_TRANSFORM=True, MAX_POOL=False,
            GROUP=8, FEATURE_OUTPUT_DIM=256,
            use_patch_recon=False, use_patch_feature_contrast=False,
            use_hard_negative_patch_mining=False,
        ),
        with_center=False, scale=0.35,
    ),
}


def make_ds(cfg, for_training, scale, device):
    """The synthetic split at ``cfg["NUM_POINTS"]`` points, every cloud
    hardened by ``RandomState(NOISE_SEED)`` normal noise at ``scale``."""
    import numpy as np

    from patchaugnet_tpu_torch import data

    pr = data.PlaceRecognitionDataset(
        "synthetic", for_training,
        num_pos=cfg["TRAIN_POSITIVES_PER_QUERY"],
        num_neg=cfg["TRAIN_NEGATIVES_PER_QUERY"],
        load_overlap_indices=cfg.get("use_hard_negative_patch_mining", False)
        or cfg.get("use_patch_feature_contrast", False),
        num_points=cfg["NUM_POINTS"], device=device,
    )
    pr.scene.create_synthetic(n_trips=N_TRIPS, n_per_trip=N_PER_TRIP, num_points=cfg["NUM_POINTS"])
    r = np.random.RandomState(NOISE_SEED)
    pr.scene._clouds = pr.scene._clouds + r.randn(*pr.scene._clouds.shape).astype(np.float32) * scale
    pr.scene._pc_cache.clear()
    return pr


def run(model_type="patch_aug_net", precision="float32", device="cuda", epochs=EPOCHS, max_batches=None,
        overrides=None, log=print):
    """Train ``model_type`` on the hardened scene; returns the run's record:
    the JSON line's keys, the ``steps``, ``patch_batches`` and
    ``eval_batches`` (the forward calls of both evaluations) that fix its
    kernel launches, and the trained ``state``. ``overrides`` replaces
    config keys (a small CPU run). ``SEED`` seeds the initial weights and
    the host's draws."""
    import numpy as np
    import torch

    from patchaugnet_tpu_torch import serving, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import training_init_

    t_run = time.perf_counter()
    device = serving.resolve_device(device)
    fam = FAMILIES[model_type]
    cfg = dict(fam["cfg"], **(overrides or {}))
    if precision != "float32":
        cfg["COMPUTE_DTYPE"] = precision
    train_ds = make_ds(cfg, True, fam["scale"], device)
    test_ds = make_ds(cfg, False, fam["scale"], device)
    model = training_init_(get_model(model_type, cfg), torch.Generator().manual_seed(SEED))
    state = train.create_train_state(model, cfg, steps_per_epoch=STEPS_PER_EPOCH, device=device)
    forward = train.build_forward_fn(state.model, device)
    eval_batches = 0

    def counted_forward(clouds):
        nonlocal eval_batches
        eval_batches += 1
        return forward(clouds)

    def recall1():
        out = train.evaluate(counted_forward, test_ds, top_k=EVAL_TOP_K, batch_size=EVAL_BATCH)
        return out.get("recall_at_1", 0.0)

    t0 = time.perf_counter()
    r_init = recall1()
    log(f"{model_type}: init recall@1 {r_init:.1f} ({time.perf_counter() - t0:.0f}s)")
    step = train.build_train_step(state.model, cfg)
    center_fn = train.build_center_fn(cfg["SAMPLING"][0], device) if fam["with_center"] else None
    rng, np_rng = random.Random(SEED), np.random.RandomState(SEED)
    totals, steps, patch_batches, train_s = [], 0, 0, 0.0
    for epoch in range(epochs):
        t0 = time.perf_counter()
        s = train.train_one_epoch(state, step, train_ds, cfg, epoch, rng, np_rng, center_fn=center_fn,
                                  max_batches=max_batches)
        state = s.pop("state")
        train_s += time.perf_counter() - t0
        totals.append(s["total"])
        steps += s["batches"]
        patch_batches += s["patch_batches"]
        log(f"epoch {epoch}: total {s['total']:.3f} pr {s['place_recognition']:.3f} "
            f"({s['batches']} steps, {time.perf_counter() - t0:.0f}s)")
    r_final = recall1()
    log(f"{model_type}: TRAINED recall@1 {r_final:.1f} (init {r_init:.1f})")
    return {
        "family": model_type, "precision": precision, "recall_at_1_init": r_init, "recall_at_1_trained": r_final,
        "epoch_totals": totals, "ms_per_step": train_s * 1e3 / max(steps, 1), "seconds": time.perf_counter() - t_run,
        "steps": steps, "patch_batches": patch_batches, "eval_batches": eval_batches, "state": state,
    }


def record_line(result):
    """The run's JSON line (every key of ``run``'s record but the state)."""
    return json.dumps({k: v for k, v in result.items() if k != "state"})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_type", default="patch_aug_net", choices=sorted(FAMILIES))
    ap.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="gpu (the card, the default) or cpu")
    args = ap.parse_args(argv)
    from patchaugnet_tpu_torch.serving import platform_device

    result = run(args.model_type, args.precision, platform_device(args.platform), log=lambda s: print(s, flush=True))
    print(record_line(result), flush=True)
    return result


if __name__ == "__main__":
    main()
