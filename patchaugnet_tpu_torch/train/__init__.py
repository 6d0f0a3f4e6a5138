"""Training: the train state, the optimizer and its schedule,
checkpoints, and the train step of PatchAugNet."""
from .state import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_schedule,
    restore_checkpoint,
    save_checkpoint,
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
]
