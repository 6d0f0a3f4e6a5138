"""Core NN building blocks (channels-last).

Port of ``patchaugnet_tpu/nn/core.py``. A shared MLP over the channel
axis is a ``Linear`` over the trailing axis of a channels-last tensor (the
reference's 1x1 ``Conv2d`` over ``(B, C, M, K)``), with no bias before a
BatchNorm. Attribute names follow the JAX variable tree (``layer{i}``,
``bn{i}``, ``fc{i}``) so that ``compat.jax_params`` maps weights by walking
the modules.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax's: running = 0.9 * running + 0.1 * batch (torch's momentum 0.1)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing axis.

    Counterpart of ``batch_norm`` of the JAX package, with flax's
    arithmetic: ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.
    Parameter and buffer names are torch's. Eval mode normalises with the
    running statistics. Train mode normalises with the batch statistics,
    reduced over every leading axis as flax does (``use_fast_variance``:
    ``var = max(mean(x^2) - mean(x)^2, 0)``, the biased variance), and
    updates the running statistics in place:
    ``running = BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch``.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return (x - self.running_mean) * mul + self.bias
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean) * mul + self.bias


class SharedMLP(nn.Module):
    """Stack of Linear + BN + ReLU over the last axis of a tensor of any rank."""

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.depth = len(features)
        for i, f in enumerate(features):
            setattr(self, f"layer{i}", nn.Linear(in_features, f, bias=False))
            setattr(self, f"bn{i}", BatchNorm(f))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"layer{i}")(x)))
        return x


class MLP(nn.Module):
    """FC stack with BN+ReLU after every layer but the last (unless
    ``final_activation``), reference ``pt_util.FC``."""

    def __init__(self, in_features: int, features: Sequence[int], bn: bool = True,
                 final_activation: bool = False):
        super().__init__()
        self.acts = []
        for i, f in enumerate(features):
            act = i < len(features) - 1 or final_activation
            use_bn = bn and act
            setattr(self, f"fc{i}", nn.Linear(in_features, f, bias=not use_bn))
            if use_bn:
                setattr(self, f"bn{i}", BatchNorm(f))
            self.acts.append(act)
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, act in enumerate(self.acts):
            x = getattr(self, f"fc{i}")(x)
            if hasattr(self, f"bn{i}"):
                x = getattr(self, f"bn{i}")(x)
            if act:
                x = torch.relu(x)
        return x


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2)`` semantics: x / max(||x||, eps)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / norm.clamp_min(eps)


@torch.no_grad()
def seeded_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BatchNorm statistic of ``model`` from
    ``generator`` (a CPU generator; values are copied to the model's
    device), in ``named_parameters``/``named_buffers`` order.

    Weights are normal with std ``1/sqrt(fan_in)``, biases normal with std
    0.1. The fan-in is the input width of a ``Linear``, and of a raw
    parameter the fan its JAX initialiser takes where its module names one
    in ``init_fan`` (``{name: fan}``), else its second-to-last axis (its
    only axis for a vector). A raw parameter that its module names in
    ``init_value`` (``{name: value}``, GeM's ``p``) takes that constant,
    as its JAX initialiser gives it. The child modules that a module names in
    ``zero_init`` (STN3D's ``fc3``) start at zero, weight and bias, as
    their JAX initialisers make them. BatchNorm scale and running variance
    are uniform in [0.5, 1.5] and its bias and running mean normal with
    std 0.1, away from the 1/0 defaults, so that an eval forward exercises
    every BN.
    """
    for module in model.modules():
        own = [*module.named_parameters(recurse=False), *module.named_buffers(recurse=False)]
        fans = getattr(module, "init_fan", {})
        values = getattr(module, "init_value", {})
        for name, t in own:
            shape = tuple(t.shape)
            if name in values:
                value = torch.full(shape, values[name])
            elif isinstance(module, BatchNorm) and name in ("weight", "running_var"):
                value = torch.rand(shape, generator=generator) + 0.5
            elif name in ("bias", "running_mean"):
                value = torch.randn(shape, generator=generator) * 0.1
            else:
                if isinstance(module, nn.Linear):
                    fan = shape[1]
                elif name in fans:
                    fan = fans[name]
                else:
                    fan = shape[-2] if len(shape) >= 2 else shape[0]
                value = torch.randn(shape, generator=generator) / fan ** 0.5
            t.copy_(value.to(t.dtype))
    for module in model.modules():
        for child in getattr(module, "zero_init", ()):
            for t in getattr(module, child).parameters():
                t.zero_()
    return model


@torch.no_grad()
def training_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """A model as training starts from it (the CLIs' initialisation, where
    the JAX CLIs call ``model.init``): the weights of :func:`seeded_init_`
    (normal with std ``1/sqrt(fan_in)``, the ``zero_init`` modules at
    zero, so every STN3D starts at the identity), zero biases, and every
    BatchNorm at its defaults (scale 1, bias 0, running mean 0, running
    variance 1)."""
    seeded_init_(model, generator)
    for module in model.modules():
        for name, t in [*module.named_parameters(recurse=False), *module.named_buffers(recurse=False)]:
            if name in ("bias", "running_mean"):
                t.zero_()
            elif isinstance(module, BatchNorm) and name in ("weight", "running_var"):
                t.fill_(1.0)
    return model
