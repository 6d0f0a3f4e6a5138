"""Eval BatchNorm and ReLU in one pass (``torch.ops.pan.bn_relu``).

A port-only kernel: ``relu((x - mean) * mul + bias)`` over the trailing
axis of a channels-last f32 tensor, the expression of
:class:`nn.core.BatchNorm` in eval mode (``mul = rsqrt(running_var +
eps) * weight``) followed by ``torch.relu``. torch runs it as four passes
over the tensor, three of them broadcasting a ``(C,)`` vector; the CUDA
kernel (``csrc/bn_relu.cu``) reads each element once and writes it once,
and its result equals the four passes' bit for bit. The CPU
implementation is the expression itself, and a fake one gives the shape,
so an exported program holds one ``pan.bn_relu`` node per call.
``BatchNorm.relu`` decides when to call it; the operator has no autograd
formula.
"""
from __future__ import annotations

import torch

from .cuda import launch
from .library import LIB

# kernel launches so far
launches = 0


def bn_relu(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``relu((x - mean) * mul + bias)``, the vectors broadcast over the
    trailing axis of ``x``.

    Args:
      x: ``(..., C)`` f32, contiguous.
      mean, mul, bias: ``(C,)`` f32, contiguous, on ``x``'s device.

    Returns:
      A new ``(..., C)`` f32 tensor, by ``torch.ops.pan.bn_relu``: a CUDA
      tensor runs the kernel, a CPU tensor the expression. Raises
      ``ValueError`` on any other input.
    """
    return torch.ops.pan.bn_relu(x, mean, mul, bias)


def _check(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() == 0 or not x.is_contiguous():
        raise ValueError(f"x {x.dtype} {tuple(x.shape)}: pan::bn_relu takes a contiguous f32 tensor of rank >= 1")
    c = x.shape[-1]
    for name, v in (("mean", mean), ("mul", mul), ("bias", bias)):
        if v.dtype != torch.float32 or v.shape != (c,) or not v.is_contiguous() or v.device != x.device:
            raise ValueError(f"{name} {v.dtype} {tuple(v.shape)} on {v.device}: pan::bn_relu takes a contiguous "
                             f"f32 ({c},) vector on {x.device} for x {tuple(x.shape)}")


def _bn_relu_kernel(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``pan::bn_relu`` for CUDA: one launch of the kernel, counted in
    ``launches``; float4 loads where ``C % 4 == 0`` and every pointer is
    16-byte aligned."""
    global launches
    _check(x, mean, mul, bias)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n, c = x.numel(), x.shape[-1]
    if n == 0:
        return y
    ptrs = [t.data_ptr() for t in (x, mean, mul, bias, y)]
    vec = c % 4 == 0 and not any(p % 16 for p in ptrs)
    launch("bn_relu", "pan_bn_relu", x.device, *ptrs, n, c, int(vec))
    launches += 1
    return y


def _bn_relu_plain(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``pan::bn_relu`` for the CPU: the expression, as four torch passes."""
    _check(x, mean, mul, bias)
    return torch.relu((x - mean) * mul + bias)


def _bn_relu_fake(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


LIB.impl("bn_relu", _bn_relu_kernel, "CUDA")
LIB.impl("bn_relu", _bn_relu_plain, "CPU")
torch.library.register_fake("pan::bn_relu", _bn_relu_fake, lib=LIB)
