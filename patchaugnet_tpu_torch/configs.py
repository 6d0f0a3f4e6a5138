"""Model and training configurations, as plain dicts.

``PATCH_AUG_NET`` is a copy of the model keys of
``configs/patch_aug_net.yaml`` (the full-width PatchAugNet that the
descriptor benchmark serves), and ``PATCH_AUG_NET_TRAIN`` adds its
training keys (the tuple batch, margins, loss flags and weights,
optimizer and schedule, the a2b table sizes), kept here so that the port
needs neither PyYAML nor the JAX package's entry modules. A test holds
both equal to the YAML file.
"""

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
)
