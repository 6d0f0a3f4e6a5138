"""Training: the train state, the optimizer and its schedule,
checkpoints, the train step of PatchAugNet, PPT-Net and PointNetVLAD,
the TruncatedSmoothAP trainer of MinkLoc3Dv2, and the epoch loops."""
from .state import (
    TrainState,
    Tx,
    create_train_state,
    make_optimizer,
    make_schedule,
    restore_checkpoint,
    save_checkpoint,
)
from .loop import HARD_NEG_EPOCH, METRIC_FETCH_LAG, evaluate, prepare_patch_inputs, train_one_epoch
from .smoothap import (
    build_masks,
    build_smoothap_train_step,
    multistep_schedule,
    sample_smoothap_batch,
    smoothap_optimizer,
    train_one_epoch_smoothap,
)
from .step import (
    build_center_fn,
    build_forward_fn,
    build_local_forward_fn,
    build_train_step,
    empty_patch_inputs,
    make_loss_fn,
)

__all__ = [
    "TrainState",
    "Tx",
    "create_train_state",
    "make_optimizer",
    "make_schedule",
    "save_checkpoint",
    "restore_checkpoint",
    "make_loss_fn",
    "build_train_step",
    "build_forward_fn",
    "build_local_forward_fn",
    "build_center_fn",
    "empty_patch_inputs",
    "prepare_patch_inputs",
    "train_one_epoch",
    "evaluate",
    "HARD_NEG_EPOCH",
    "METRIC_FETCH_LAG",
    "sample_smoothap_batch",
    "build_masks",
    "smoothap_optimizer",
    "build_smoothap_train_step",
    "train_one_epoch_smoothap",
    "multistep_schedule",
]
