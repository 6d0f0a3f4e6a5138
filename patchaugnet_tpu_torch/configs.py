"""Model and training configurations, as plain dicts.

``PATCH_AUG_NET`` is a copy of the model keys of
``configs/patch_aug_net.yaml`` (the full-width PatchAugNet that the
descriptor benchmark serves). ``PATCH_AUG_NET_TRAIN`` holds every key of
that file: the model keys, the training keys (the tuple batch, margins,
loss flags and weights, optimizer and schedule, the a2b table sizes) and
the keys the CLIs read (the seed, the experiment directory, the eval
tuple sizes, the dataset). ``TINY_SMOKE`` is ``configs/tiny_smoke.yaml``,
the CPU smoke configuration. ``PPTNET_ORIGIN``, ``POINTNET_VLAD`` and
``MINKLOC3DV2`` hold every key of ``configs/pptnet_origin.yaml``,
``configs/pointnet_vlad.yaml`` and ``configs/minkloc3dv2.yaml``.
They are kept here so that the port needs neither PyYAML nor the JAX
package's entry modules; a test holds each equal to its YAML file.
"""
import copy
import os
from typing import Any, Dict

PATCH_AUG_NET = dict(
    model_type="patch_aug_net",
    AGGREGATION="spvlad",
    AGGREGATION_TYPE=2,
    GROUP=8,
    NUM_POINTS=4096,
    FEATURE_OUTPUT_DIM=256,
    FEATURE_SIZE=[256, 256, 256],
    MAX_SAMPLES=[128, 1024, 4096],
    CLUSTER_SIZE=[4, 16, 64],
    OUTPUT_DIM=[256, 256, 256],
    USE_ORIGIN_PC_IN_FP=True,
    GATING=False,
    SAMPLING=[1024, 128, 16],
    KNN=[20, 20, 20],
    KNN_DILATION=2,
    use_patch_recon=True,
    use_patch_feature_contrast=True,
)

PATCH_AUG_NET_TRAIN = dict(
    PATCH_AUG_NET,
    use_hard_negative_patch_mining=True,
    weight_place_recognition=1.0,
    weight_patch_recon=0.25,
    weight_patch_feature_contrast=0.25,
    TRAIN_BATCH_SIZE=4,
    TRAIN_POSITIVES_PER_QUERY=2,
    TRAIN_NEGATIVES_PER_QUERY=14,
    BASE_LEARNING_RATE=0.0005,
    MOMENTUM=0.9,
    OPTIMIZER="adam",
    MAX_EPOCH=30,
    LEARNING_RATE_DECAY="step",
    MARGIN_1=0.5,
    MARGIN_2=0.2,
    LOSS_FUNCTION="quadruplet",
    LOSS_LAZY=True,
    TRIPLET_USE_BEST_POSITIVES=False,
    LOSS_IGNORE_ZERO_BATCH=False,
    A2B_MAX_ROWS=2048,
    A2B_MAX_PAIRS=16,
    MANUAL_SEED=123,
    USE_SPA_ATT_AFTER_FP=True,
    EXP_DIR="exp",
    DATA_AUGMENTATION=True,
    EVAL_BATCH_SIZE=1,
    EVAL_POSITIVES_PER_QUERY=4,
    EVAL_NEGATIVES_PER_QUERY=10,
    dataset="oxford",
)

TINY_SMOKE = dict(
    PATCH_AUG_NET_TRAIN,
    NUM_POINTS=128,
    MAX_SAMPLES=[8, 32, 128],
    SAMPLING=[32, 8, 4],
    KNN=[8, 8, 4],
    TRAIN_BATCH_SIZE=2,
    TRAIN_NEGATIVES_PER_QUERY=4,
    MAX_EPOCH=1,
    A2B_MAX_ROWS=64,
    A2B_MAX_PAIRS=4,
    dataset="synthetic",
)

_TRAIN_KEYS = dict(
    MANUAL_SEED=123,
    use_patch_recon=False,
    use_patch_feature_contrast=False,
    use_hard_negative_patch_mining=False,
    weight_place_recognition=1.0,
    weight_patch_recon=0.25,
    weight_patch_feature_contrast=0.25,
    EXP_DIR="exp",
    TRAIN_POSITIVES_PER_QUERY=2,
    BASE_LEARNING_RATE=0.0005,
    MOMENTUM=0.9,
    OPTIMIZER="adam",
    MAX_EPOCH=30,
    LEARNING_RATE_DECAY="step",
    MARGIN_1=0.5,
    MARGIN_2=0.2,
    LOSS_FUNCTION="quadruplet",
    LOSS_LAZY=True,
    TRIPLET_USE_BEST_POSITIVES=False,
    LOSS_IGNORE_ZERO_BATCH=False,
    EVAL_BATCH_SIZE=1,
    EVAL_POSITIVES_PER_QUERY=4,
    EVAL_NEGATIVES_PER_QUERY=10,
    dataset="oxford",
)

PPTNET_ORIGIN = dict(
    _TRAIN_KEYS,
    model_type="pptnet",
    GROUP=8,
    AGGREGATION="spvlad",
    NUM_POINTS=4096,
    FEATURE_OUTPUT_DIM=256,
    FEATURE_SIZE=[256, 256, 256, 256],
    MAX_SAMPLES=[64, 256, 1024, 4096],
    CLUSTER_SIZE=[1, 4, 16, 64],
    OUTPUT_DIM=[256, 256, 256, 256],
    GATING=True,
    SAMPLING=[1024, 256, 64, 16],
    KNN=[20, 20, 20, 20],
    TRAIN_BATCH_SIZE=1,
    TRAIN_NEGATIVES_PER_QUERY=14,
)

POINTNET_VLAD = dict(
    _TRAIN_KEYS,
    model_type="pointnet_vlad",
    GLOBAL_FEAT=True,
    FEATURE_TRANSFORM=True,
    MAX_POOL=False,
    GROUP=8,
    NUM_POINTS=4096,
    FEATURE_OUTPUT_DIM=256,
    TRAIN_BATCH_SIZE=2,
    TRAIN_NEGATIVES_PER_QUERY=18,
    BASE_LEARNING_RATE=0.000005,
    MAX_EPOCH=20,
    EVAL_BATCH_SIZE=2,
    EVAL_NEGATIVES_PER_QUERY=12,
)

MINKLOC3DV2 = dict(
    MANUAL_SEED=123,
    model_type="minkloc3dv2",
    use_patch_recon=False,
    use_patch_feature_contrast=False,
    use_hard_negative_patch_mining=False,
    weight_place_recognition=1.0,
    weight_patch_recon=0.0,
    weight_patch_feature_contrast=0.0,
    NUM_POINTS=4096,
    FEATURE_OUTPUT_DIM=256,
    model="MinkLoc",
    planes=[64, 128, 64, 32],
    layers=[1, 1, 1, 1],
    num_top_down=2,
    conv0_kernel_size=5,
    feature_size=256,
    output_dim=256,
    block="ECABasicBlock",
    pooling="GeM",
    coordinates="cartesian",
    quantization_step=0.01,
    normalize_embeddings=False,
    EXP_DIR="exp",
    TRAIN_BATCH_SIZE=2,
    TRAIN_POSITIVES_PER_QUERY=2,
    TRAIN_NEGATIVES_PER_QUERY=14,
    BASE_LEARNING_RATE=0.001,
    MOMENTUM=0.9,
    OPTIMIZER="adam",
    MAX_EPOCH=400,
    LEARNING_RATE_DECAY="step",
    WEIGHT_DECAY=0.0001,
    MARGIN_1=0.5,
    MARGIN_2=0.2,
    LOSS_FUNCTION="truncatedsmoothap",
    LOSS_LAZY=True,
    TRIPLET_USE_BEST_POSITIVES=False,
    LOSS_IGNORE_ZERO_BATCH=False,
    positives_per_query=4,
    tau1=0.01,
    EVAL_BATCH_SIZE=1,
    EVAL_POSITIVES_PER_QUERY=4,
    EVAL_NEGATIVES_PER_QUERY=10,
    dataset="oxford",
)

# the configuration files the port knows without PyYAML, by file name
KNOWN_CONFIGS = {"patch_aug_net.yaml": PATCH_AUG_NET_TRAIN, "tiny_smoke.yaml": TINY_SMOKE,
                 "pptnet_origin.yaml": PPTNET_ORIGIN, "pointnet_vlad.yaml": POINTNET_VLAD,
                 "minkloc3dv2.yaml": MINKLOC3DV2}


def load_config(path: str) -> Dict[str, Any]:
    """A configuration file as a dict: read with PyYAML where it imports,
    else the port's copy of a known file (``KNOWN_CONFIGS``, by file name).
    Any other file without PyYAML raises ``ImportError``."""
    try:
        import yaml
    except ImportError:
        known = KNOWN_CONFIGS.get(os.path.basename(path))
        if known is None:
            raise ImportError(
                f"reading {path} needs PyYAML (the 'yaml' package), which is not installed; without it "
                f"the port knows only {sorted(KNOWN_CONFIGS)}") from None
        return copy.deepcopy(known)
    with open(path) as f:
        return yaml.safe_load(f)
