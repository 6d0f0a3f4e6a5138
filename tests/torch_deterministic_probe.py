"""Deterministic training-quality probe of the port (the counterpart of
``tests/deterministic_probe.py``).

Trains the tiny flagship config on the noise-hardened synthetic scene (2
trips x 12 submaps of 128 points) for 8 epochs of 8 batches, evaluates
recall@1 with the trained f32 weights through the f32 forward and through
the bf16 one (``COMPUTE_DTYPE: bfloat16``), and prints one line:

    DETPROBE recall=<float> recall_bf16=<float> params_sha=<hex16>

    python tests/torch_deterministic_probe.py [--platform cpu]

It runs on the card unless ``--platform cpu`` is given. On the card it
runs under ``torch.use_deterministic_algorithms(True)`` (warn-only, so
that every operation without a deterministic implementation is named at
once), with ``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call;
if any operation warned, it prints their names on a ``DETPROBE_NONDET``
line to stderr and exits with code 3. Two invocations on one machine must
print the same line; ``chip_smoke.py`` phase 14 runs it twice, each in a
fresh process, and pins the trained recall. ``probe(...)`` does the work
in-process.
"""
import argparse
import hashlib
import os
import random
import sys
import warnings

# cuBLAS picks a deterministic reduction only with a fixed workspace; the
# variable must be set before the first cuBLAS call of the process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the tiny flagship config of the JAX suite (tests/test_train.py SMALL_CFG)
SMALL_CFG = {
    "model_type": "patch_aug_net",
    "use_patch_recon": True,
    "use_patch_feature_contrast": True,
    "use_hard_negative_patch_mining": True,
    "AGGREGATION": "spvlad",
    "AGGREGATION_TYPE": 2,
    "GROUP": 8,
    "NUM_POINTS": 128,
    "FEATURE_OUTPUT_DIM": 256,
    "FEATURE_SIZE": [256, 256, 256],
    "MAX_SAMPLES": [8, 32, 128],
    "CLUSTER_SIZE": [4, 16, 64],
    "OUTPUT_DIM": [256, 256, 256],
    "USE_ORIGIN_PC_IN_FP": True,
    "GATING": False,
    "SAMPLING": [32, 8, 4],
    "KNN": [8, 8, 4],
    "KNN_DILATION": 2,
    "TRAIN_BATCH_SIZE": 2,
    "TRAIN_POSITIVES_PER_QUERY": 1,
    "TRAIN_NEGATIVES_PER_QUERY": 2,
    "BASE_LEARNING_RATE": 0.001,
    "MOMENTUM": 0.9,
    "OPTIMIZER": "adam",
    "MAX_EPOCH": 2,
    "LEARNING_RATE_DECAY": "step",
    "MARGIN_1": 0.5,
    "MARGIN_2": 0.2,
    "LOSS_FUNCTION": "quadruplet",
    "LOSS_LAZY": True,
    "TRIPLET_USE_BEST_POSITIVES": False,
    "LOSS_IGNORE_ZERO_BATCH": False,
    "A2B_MAX_ROWS": 64,
    "A2B_MAX_PAIRS": 4,
}
N_TRIPS, N_PER_TRIP = 2, 12
NOISE_SCALE, NOISE_SEED = 0.35, 7
EPOCHS, MAX_BATCHES = 8, 8
EVAL_TOP_K, EVAL_BATCH = 5, 6


def make_ds(for_training, device):
    """The hardened 2 x 12 synthetic split of 128-point clouds."""
    import numpy as np

    from patchaugnet_tpu_torch import data

    pr = data.PlaceRecognitionDataset(
        "synthetic", for_training,
        num_pos=SMALL_CFG["TRAIN_POSITIVES_PER_QUERY"], num_neg=SMALL_CFG["TRAIN_NEGATIVES_PER_QUERY"],
        load_overlap_indices=True, num_points=SMALL_CFG["NUM_POINTS"], device=device,
    )
    pr.scene.create_synthetic(n_trips=N_TRIPS, n_per_trip=N_PER_TRIP, num_points=SMALL_CFG["NUM_POINTS"])
    r = np.random.RandomState(NOISE_SEED)
    pr.scene._clouds = pr.scene._clouds + r.randn(*pr.scene._clouds.shape).astype(np.float32) * NOISE_SCALE
    pr.scene._pc_cache.clear()
    return pr


def probe(device="cuda", epochs=EPOCHS, max_batches=MAX_BATCHES):
    """Train and evaluate; returns ``(recall, recall_bf16, params_sha,
    model)``: ``params_sha`` the first 16 hex digits of the SHA-256 of
    every parameter's bytes, the model the trained f32 one."""
    import numpy as np
    import torch

    from patchaugnet_tpu_torch import serving, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import training_init_

    device = serving.resolve_device(device)
    cfg = dict(SMALL_CFG)
    train_ds, test_ds = make_ds(True, device), make_ds(False, device)
    model = training_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(0))
    state = train.create_train_state(model, cfg, device=device)
    step = train.build_train_step(state.model, cfg)
    center_fn = train.build_center_fn(cfg["SAMPLING"][0], device)
    rng, np_rng = random.Random(0), np.random.RandomState(0)
    for epoch in range(epochs):
        summary = train.train_one_epoch(state, step, train_ds, cfg, epoch, rng, np_rng, center_fn=center_fn,
                                        max_batches=max_batches)
        state = summary.pop("state")
    forward = train.build_forward_fn(state.model, device)
    recall = train.evaluate(forward, test_ds, top_k=EVAL_TOP_K, batch_size=EVAL_BATCH).get("recall_at_1", 0.0)
    # the bf16 serving leg: the same trained f32 weights through the
    # COMPUTE_DTYPE=bfloat16 forward
    model16 = get_model("patch_aug_net", dict(cfg, COMPUTE_DTYPE="bfloat16"))
    model16.load_state_dict(state.model.state_dict())
    forward16 = train.build_forward_fn(model16, device)
    recall16 = train.evaluate(forward16, test_ds, top_k=EVAL_TOP_K, batch_size=EVAL_BATCH).get("recall_at_1", 0.0)
    h = hashlib.sha256()
    for p in state.model.parameters():
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return recall, recall16, h.hexdigest()[:16], state.model


def probe_line(recall, recall16, sha):
    return f"DETPROBE recall={recall:.6f} recall_bf16={recall16:.6f} params_sha={sha}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"], help="gpu (the card, the default) or cpu")
    args = ap.parse_args(argv)
    import torch

    from patchaugnet_tpu_torch.serving import platform_device

    device = platform_device(args.platform)
    if device.type != "cuda":
        print(probe_line(*probe(device)[:3]), flush=True)
        return 0
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = probe(device)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0][:160]
                     for w in caught if "deterministic" in str(w.message)})
    if nondet:
        print(f"DETPROBE_NONDET {nondet}", file=sys.stderr, flush=True)
        return 3
    print(probe_line(*result[:3]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
