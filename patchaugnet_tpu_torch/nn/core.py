"""Core NN building blocks (channels-last).

Port of ``patchaugnet_tpu/nn/core.py``. A shared MLP over the channel
axis is a ``Linear`` over the trailing axis of a channels-last tensor (the
reference's 1x1 ``Conv2d`` over ``(B, C, M, K)``), with no bias before a
BatchNorm. Attribute names follow the JAX variable tree (``layer{i}``,
``bn{i}``, ``fc{i}``) so that ``compat.jax_params`` maps weights by walking
the modules.

Mixed precision (a config's ``COMPUTE_DTYPE``, :func:`compute_dtype`): a
:class:`Dense` with a ``dtype`` casts its input, weight and bias to it and
returns that dtype (flax ``nn.Dense(dtype=)``); :class:`BatchNorm` reduces
its statistics and normalises in f32 whatever its input, and returns the
input's dtype (flax ``BatchNorm(dtype=)``). Parameters and statistics stay
f32. With no compute dtype every cast is a no-op.

Where an eval BatchNorm feeds a ReLU, the sites call
:meth:`BatchNorm.relu`, which runs both in one pass
(``ops.norm.bn_relu``) when nothing needs the separate passes: eval mode,
no autograd recorded, an f32 contiguous input. :data:`bn_relu_counts`
counts, per eval call, which path it took.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import bn_relu

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax's: running = 0.9 * running + 0.1 * batch (torch's momentum 0.1)

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
_frozen_running_stats = 0   # > 0 inside frozen_running_stats()
_stats_group: Optional[Tuple[Any, int]] = None   # (process group, its size) inside batch_stats_group()
# eval-mode BatchNorm.relu calls so far, by path: one pass (pan.bn_relu) or the BatchNorm then torch.relu
bn_relu_counts = {"fused": 0, "unfused": 0}


def compute_dtype(param: Mapping[str, Any]) -> Optional[torch.dtype]:
    """The feature path's dtype of a model config: its ``COMPUTE_DTYPE``
    (MinkLoc3Dv2's flat configs may say ``compute_dtype``) by name,
    ``"bfloat16"``, ``"float16"`` or ``"float32"``; ``None`` (the key
    unset) is the exact f32 path."""
    value = param.get("COMPUTE_DTYPE", param.get("compute_dtype"))
    if value is None:
        return None
    if value not in _COMPUTE_DTYPES:
        raise ValueError(f"COMPUTE_DTYPE={value!r}: expected one of {sorted(_COMPUTE_DTYPES)} or None")
    return _COMPUTE_DTYPES[value]


@contextlib.contextmanager
def frozen_running_stats() -> Iterator[None]:
    """Train-mode BatchNorms inside leave their running statistics as they
    are (they still normalise with the batch statistics): the recomputed
    forward of a rematerialised step must not update them a second time."""
    global _frozen_running_stats
    _frozen_running_stats += 1
    try:
        yield
    finally:
        _frozen_running_stats -= 1


@contextlib.contextmanager
def batch_stats_group(group, size: int) -> Iterator[None]:
    """Train-mode BatchNorms inside take their batch statistics over every
    rank of ``group`` (``size`` ranks, each holding as many rows): each
    rank's mean and mean of squares are averaged over the group by one
    ``all_reduce`` that carries autograd, so the statistics are those of
    the whole batch, as the JAX package's data-parallel step takes them
    under GSPMD. The running update and eval mode are unchanged; a group of
    one gives today's statistics bit for bit."""
    global _stats_group
    previous, _stats_group = _stats_group, (group, size)
    try:
        yield
    finally:
        _stats_group = previous


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (one ``all_reduce``), as a
    new tensor. The sum carries autograd
    (``torch.distributed.nn.functional.all_reduce``): its backward sums the
    gradients over the group."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


def group_max(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s elementwise maximum over the ranks of ``group``, as a new
    tensor; for forwards without autograd (the max's gradient is not
    carried)."""
    import torch.distributed as dist

    if t.requires_grad:
        raise ValueError("group_max carries no gradient: run it without autograd")
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def _group_means(mean: torch.Tensor, meansq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank means averaged over the group of :func:`batch_stats_group`."""
    group, size = _stats_group
    both = group_sum(torch.stack([mean, meansq]), group) / size
    return both[0], both[1]


class Dense(nn.Linear):
    """``nn.Linear`` at a compute dtype: with ``dtype`` set, the input,
    weight and bias are cast to it and the product (accumulated in f32)
    comes out in it, as flax ``nn.Dense(dtype=)``; the parameters stay
    f32. ``dtype=None`` is ``nn.Linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class BatchNorm(nn.Module):
    """BatchNorm over the trailing axis.

    Counterpart of ``batch_norm`` of the JAX package, with flax's
    arithmetic: ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.
    Parameter and buffer names are torch's. Eval mode normalises with the
    running statistics. Train mode normalises with the batch statistics,
    reduced over every leading axis as flax does (``use_fast_variance``:
    ``var = max(mean(x^2) - mean(x)^2, 0)``, the biased variance), and
    updates the running statistics in place:
    ``running = momentum * running + (1 - momentum) * batch``, flax's
    convention (``momentum`` is ``BN_MOMENTUM`` unless given; CBAM's
    spatial attention takes 0.99), not inside
    :func:`frozen_running_stats`; inside
    :func:`batch_stats_group` the batch statistics are the group's. A lower-precision input is
    reduced and normalised in f32, and the result cast back to its dtype.
    """

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if not self.training:
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return ((xf - self.running_mean) * mul + self.bias).to(x.dtype)
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(axes)
        meansq = (xf * xf).mean(axes)
        if _stats_group is not None:
            mean, meansq = _group_means(mean, meansq)
        var = torch.clamp_min(meansq - mean * mean, 0.0)
        self.update_running(mean, var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)

    def relu(self, x: torch.Tensor) -> torch.Tensor:
        """``torch.relu(self(x))``. In eval mode, where no autograd is
        recorded (neither ``x`` nor the scale and shift need a gradient
        while it is enabled) and ``x`` is f32 and contiguous, in one pass
        (``ops.norm.bn_relu``, the same bits); otherwise (train mode, a
        lower-precision input, a forward that needs gradients) as the two
        modules. Eval calls are counted in :data:`bn_relu_counts`."""
        if self.training:
            return torch.relu(self(x))
        if (x.dtype == torch.float32 and x.is_contiguous()
                and not (torch.is_grad_enabled()
                         and (x.requires_grad or self.weight.requires_grad or self.bias.requires_grad))):
            bn_relu_counts["fused"] += 1
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return bn_relu(x, self.running_mean, mul, self.bias)
        bn_relu_counts["unfused"] += 1
        return torch.relu(self(x))

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = momentum * running + (1 - momentum) * batch``, in
        place, unless inside :func:`frozen_running_stats`."""
        if _frozen_running_stats:
            return
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class SharedMLP(nn.Module):
    """Stack of Linear + BN + ReLU over the last axis of a tensor of any
    rank, at the compute ``dtype`` (None: f32)."""

    def __init__(self, in_features: int, features: Sequence[int], dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth = len(features)
        for i, f in enumerate(features):
            setattr(self, f"layer{i}", Dense(in_features, f, bias=False, dtype=dtype))
            setattr(self, f"bn{i}", BatchNorm(f))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"bn{i}").relu(getattr(self, f"layer{i}")(x))
        return x


class MLP(nn.Module):
    """FC stack with BN+ReLU after every layer but the last (unless
    ``final_activation``), reference ``pt_util.FC``, at the compute
    ``dtype`` (None: f32)."""

    def __init__(self, in_features: int, features: Sequence[int], bn: bool = True,
                 final_activation: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.acts = []
        for i, f in enumerate(features):
            act = i < len(features) - 1 or final_activation
            use_bn = bn and act
            setattr(self, f"fc{i}", Dense(in_features, f, bias=not use_bn, dtype=dtype))
            if use_bn:
                setattr(self, f"bn{i}", BatchNorm(f))
            self.acts.append(act)
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, act in enumerate(self.acts):
            x = getattr(self, f"fc{i}")(x)
            if hasattr(self, f"bn{i}"):      # a BatchNorm only before an activation
                x = getattr(self, f"bn{i}").relu(x)
            elif act:
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
    every BN; a LayerNorm's scale and bias likewise.
    """
    for module in model.modules():
        own = [*module.named_parameters(recurse=False), *module.named_buffers(recurse=False)]
        fans = getattr(module, "init_fan", {})
        values = getattr(module, "init_value", {})
        for name, t in own:
            shape = tuple(t.shape)
            if name in values:
                value = torch.full(shape, values[name])
            elif isinstance(module, (BatchNorm, nn.LayerNorm)) and name in ("weight", "running_var"):
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
    BatchNorm and LayerNorm at its defaults (scale 1, bias 0, running mean
    0, running variance 1)."""
    seeded_init_(model, generator)
    for module in model.modules():
        for name, t in [*module.named_parameters(recurse=False), *module.named_buffers(recurse=False)]:
            if name in ("bias", "running_mean"):
                t.zero_()
            elif isinstance(module, (BatchNorm, nn.LayerNorm)) and name in ("weight", "running_var"):
                t.fill_(1.0)
    return model
