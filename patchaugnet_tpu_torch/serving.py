"""Descriptor serving: the eval forwards of the port's models.

Counterparts of ``build_forward_fn`` / ``build_local_forward_fn`` of
``patchaugnet_tpu/train/step.py``: a callable that takes a batch of
``(B, N, 3)`` f32 clouds and returns global descriptors ``(B, D)``, or
``(global, local, center_idx)`` with local = the second-to-last
feature-propagation level and centre indices = level-1 centres in the
input cloud, for the models that have them (PatchAugNet, PPT-Net; the
local forward of PointNetVLAD is ``None``). Each batch runs under
``torch.inference_mode()`` on the model's device, with the model in eval
mode whatever mode it was left in (a train step puts it in train mode),
and leaves that mode as it was: the JAX forwards pass ``train=False`` on
every call. (The JAX package's
exported artifact has no counterpart yet.)
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .models import PatchAugNet, PPTNet

Clouds = Union[torch.Tensor, np.ndarray]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises ``RuntimeError`` when CUDA is asked for and absent.

    For CUDA it also switches TF32 off for matrix products and cuDNN: the
    port computes in full f32, as the JAX CLIs pin f32 matmul precision
    (low-precision products reorder near-tied retrieval rankings).
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _prepare(model: nn.Module, device) -> torch.device:
    device = resolve_device(device)
    model.to(device)
    return device


@contextlib.contextmanager
def _eval_mode(model: nn.Module) -> Iterator[None]:
    """Eval mode and no autograd for one call; the model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def global_desc(out) -> torch.Tensor:
    """The global descriptor of a model's output: the output itself where
    the model returns a bare tensor (PointNetVLAD), else its
    ``global_desc`` (the JAX step's ``_global_desc``)."""
    return out if isinstance(out, torch.Tensor) else out.global_desc


def has_local_fields(model: nn.Module) -> bool:
    """Whether ``model``'s output carries ``fp_features`` and
    ``center_idx_origin`` (PatchAugNet, PPT-Net)."""
    return isinstance(model, (PatchAugNet, PPTNet))


def build_forward_fn(model: nn.Module, device: Union[str, torch.device] = "cuda") -> Callable:
    """``(B, N, 3) clouds -> (B, D)`` global descriptors on ``device``."""
    device = _prepare(model, device)

    def forward(clouds: Clouds) -> torch.Tensor:
        with _eval_mode(model):
            x = torch.as_tensor(clouds, dtype=torch.float32, device=device)
            return global_desc(model(x))

    return forward


def build_local_forward_fn(model: nn.Module, device: Union[str, torch.device] = "cuda") -> Optional[Callable]:
    """``(B, N, 3) clouds -> (global (B, D), local (B, K, C), center_idx (B, K))``,
    or ``None`` for a model without local descriptors (PointNetVLAD), as
    the JAX function returns."""
    if not has_local_fields(model):
        return None
    device = _prepare(model, device)

    def forward(clouds: Clouds) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with _eval_mode(model):
            x = torch.as_tensor(clouds, dtype=torch.float32, device=device)
            out = model(x)
            return out.global_desc, out.fp_features[-2], out.center_idx_origin[0]

    return forward


def platform_device(platform: str) -> torch.device:
    """The device of a CLI's ``--platform``: ``gpu`` (the card, the default
    of the CLIs) or ``cpu``. Exits with a message when the card is asked
    for and there is none: the CLIs never fall back to the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this command runs on an NVIDIA GPU; pass --platform cpu to run it on "
                         "the CPU")
    return resolve_device("cuda")
