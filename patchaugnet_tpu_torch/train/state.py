"""Train state, optimizer and schedule factories, checkpoints.

Port of ``patchaugnet_tpu/train/state.py``, the counterparts of the
reference train script's pieces:
  - the optimizer factory (``train_place_recognition.py:123-130``): Adam
    (eps 1e-8) or SGD with momentum. optax's Adam and SGD with a trace are
    torch's, term for term;
  - the learning-rate schedule (:133-139): StepLR (x0.2 every 10 epochs)
    counted in steps, and the reference's CosineAnnealingLR, which it
    builds with ``eta_min`` equal to the base rate, so constant;
  - an override of both (``create_train_state(tx=)``, as the JAX one
    takes an optax ``tx``): the SmoothAP trainer's AdamW and MultiStepLR
    (``train/smoothap.py``);
  - checkpoints (:172-189, 518-526): one ``torch.save`` payload named
    ``train_epoch_{E}_end`` with the model state, the optimizer state,
    the step, the epoch and the iteration.

The optimizer updates every parameter in every step, as optax updates
every leaf: :meth:`TrainState.apply_gradients` gives a parameter that
autograd left without a gradient a zero one (``torch.optim`` would skip
it, and its Adam step count and bias correction would fall behind).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..serving import resolve_device

Schedule = Callable[[int], float]


class Tx(NamedTuple):
    """An optimizer and its schedule, given to :func:`create_train_state` in
    place of the config's (the port's optax transformation): ``make(params,
    lr)`` builds the optimizer at the schedule's first rate."""

    make: Callable[[Iterable[nn.Parameter], float], torch.optim.Optimizer]
    schedule: Schedule


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, the
    learning-rate schedule and the number of updates applied so far."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0

    def apply_gradients(self, keep: Optional[torch.Tensor] = None) -> None:
        """One optimizer update from the parameters' ``.grad``, at the
        learning rate ``schedule(step)`` (optax reads its schedule at the
        count before the update), then ``step += 1``.

        ``keep``: an optional 0-dim bool tensor; where it is false every
        gradient is zeroed (the train step's zero-loss gate) and the update
        still runs, as in the JAX step: Adam's moments decay, its count
        grows and the parameters move by the momentum.
        """
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif keep is not None:
                p.grad.masked_fill_(~keep, 0.0)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def make_schedule(
    decay_type: str,
    base_lr: float,
    steps_per_epoch: int,
    max_epoch: int = 30,
    step_size_epochs: int = 10,
    gamma: float = 0.2,
) -> Schedule:
    """Learning rate by the step count: ``"step"`` is torch's StepLR stepped
    per epoch (x ``gamma`` at every ``step_size_epochs`` epochs); any
    other type is constant (the reference's cosine schedule has
    ``eta_min`` equal to the base rate)."""
    if decay_type != "step":
        return lambda count: base_lr
    boundaries = [e * step_size_epochs * steps_per_epoch
                  for e in range(1, max(max_epoch // step_size_epochs + 1, 2))]

    def schedule(count: int) -> float:
        lr = base_lr
        for b in boundaries:
            if count >= b:
                lr *= gamma
        return lr

    return schedule


def make_optimizer(optimizer_type: str, params, lr: float, momentum: float = 0.9) -> torch.optim.Optimizer:
    """``"momentum"``: SGD with momentum (optax ``sgd(momentum=)``); any
    other type: Adam with optax's defaults (betas 0.9, 0.999, eps 1e-8)."""
    if optimizer_type == "momentum":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(
    model: nn.Module,
    cfg: Dict[str, Any],
    steps_per_epoch: int = 1000,
    device: Union[str, torch.device] = "cuda",
    tx: Optional[Tx] = None,
) -> TrainState:
    """Move ``model`` (already filled: ``nn.seeded_init_`` or
    ``compat.load_jax_variables``) to ``device`` and give it the
    config's optimizer and schedule, or ``tx``'s. Runs on the card unless
    the caller asks for the CPU."""
    model.to(resolve_device(device))
    if tx is None:
        schedule = make_schedule(
            cfg.get("LEARNING_RATE_DECAY", "step"),
            cfg["BASE_LEARNING_RATE"],
            steps_per_epoch,
            cfg.get("MAX_EPOCH", 30),
        )
        optimizer = make_optimizer(
            cfg.get("OPTIMIZER", "adam"), model.parameters(), schedule(0), cfg.get("MOMENTUM", 0.9)
        )
    else:
        schedule = tx.schedule
        optimizer = tx.make(model.parameters(), schedule(0))
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)


def save_checkpoint(save_dir: str, state: TrainState, epoch: int, iteration: int = 0) -> str:
    """Write ``save_dir/train_epoch_{epoch}_end`` (the reference's per-epoch
    name); returns its path."""
    path = os.path.abspath(os.path.join(save_dir, f"train_epoch_{epoch}_end"))
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "epoch": epoch,
        "iteration": iteration,
    }
    torch.save(payload, path)
    return path


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Load the model, the optimizer and the step into ``state`` (the
    reference's ``--resume``); returns ``(state, epoch)``."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"])
