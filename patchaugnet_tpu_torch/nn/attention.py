"""Attention blocks (channels-last).

Port of ``patchaugnet_tpu/nn/attention.py``: ``MLPAttention`` and
``AdaptiveFeatureAggregator`` of the PatchAugNet head (reference
``loupe.py:8-66``), and the self-attention of PPT-Net's SA levels,
``GroupSA`` (grouped, reference ``SA_Layer``, ``pptnet.py:246-282``) and
``SA`` (ungrouped, reference ``SALayer``, ``loupe.py:117-156``), both with
tied Q/K weights. Sequences are ``(B, L, C)``.

``GroupSA`` takes a compute ``dtype`` (bf16), as the JAX module: its
input, projections and output are at that dtype, its energy is the
products of the rounded queries accumulated in f32, the softmax and the
column normalisation run in f32, and the attention weights are rounded
to the dtype before they weigh the values (f32 accumulation, one
rounding).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .core import BatchNorm, Dense, l2_normalize


class MLPAttention(nn.Module):
    """Per-position scalar attention (reference ``MLPAttentionLayer``).

    Scores: channel-max of a bias-free MLP, softmax over positions;
    residual ``relu(x + x * w)``.
    """

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.depth = len(channels) - 1
        for i in range(self.depth):
            setattr(self, f"mlp{i}", nn.Linear(channels[i], channels[i + 1], bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth):
            h = getattr(self, f"mlp{i}")(h)
        weights = torch.softmax(h.amax(dim=-1), dim=-1)    # (B, L)
        return torch.relu(x + x * weights[..., None])


class AdaptiveFeatureAggregator(nn.Module):
    """``B x K x C_in -> B x C_out`` (reference AFA).

    MLP-attention over the K slots, a channel-major flatten (the torch
    ``view`` of a ``(B, C, K)`` tensor), FC, BN, L2 norm.
    """

    def __init__(self, c_in: int, k: int, c_out: int):
        super().__init__()
        self.c_in, self.k = c_in, k
        self.mlpa = MLPAttention([c_in, c_in])
        self.fc = nn.Linear(c_in * k, c_out)
        self.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mlpa(x)                                    # (B, K, C)
        flat = x.transpose(-1, -2).reshape(x.shape[0], self.c_in * self.k)
        return l2_normalize(self.bn(self.fc(flat)), dim=-1)


class GroupedDense(nn.Module):
    """Grouped 1x1 conv over the channel axis, without bias: a
    block-diagonal ``(C, C)`` product, the torch ``Conv1d(C, C, 1,
    groups=gp, bias=False)``. The weight is the raw ``kernel`` of shape
    ``(gp, C/gp, C/gp)``, as in the JAX tree (not a ``Linear``, whose weight
    ``compat.jax_params`` transposes); its JAX initialiser is flax's
    ``lecun_normal``, whose fan-in is ``gp * C/gp = C`` (``init_fan``).
    At a compute ``dtype`` the input and kernel are cast to it, and each
    group's product, accumulated in f32, comes out in it."""

    def __init__(self, channels: int, gp: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if channels % gp:
            raise ValueError(f"channels={channels} is not a multiple of gp={gp}")
        self.gp, self.cg = gp, channels // gp
        self.kernel = nn.Parameter(torch.empty(gp, self.cg, self.cg))
        self.init_fan = {"kernel": channels}
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        xg = x.reshape(*x.shape[:-1], self.gp, self.cg)
        return torch.einsum("...gi,gio->...go", xg, w).reshape(x.shape)


def _tied_attention(x: torch.Tensor, xq: torch.Tensor, xv: torch.Tensor, trans_conv: nn.Module,
                    after_norm: BatchNorm) -> torch.Tensor:
    """The reference's attention with tied Q/K: energy ``xq xq^T`` (summed
    over every channel, so over the groups too), a softmax over the last
    axis, then a division by ``1e-9 +`` the sum over the query axis;
    ``x_r = attn^T v``; ``x + relu(after_norm(trans_conv(x - x_r)))``.
    Below f32 (``x``, ``xq`` and ``xv`` at one compute dtype) the energy and
    the softmax are f32 and ``attn`` is rounded to that dtype."""
    q = xq.to(torch.float32)
    energy = torch.bmm(q, q.transpose(1, 2))               # (B, N, N)
    attn = torch.softmax(energy, dim=-1)
    attn = (attn / (1e-9 + attn.sum(dim=1, keepdim=True))).to(xv.dtype)
    x_r = torch.bmm(attn.transpose(1, 2), xv)               # x_r[j] = sum_i attn[i, j] v[i]
    return x + after_norm.relu(trans_conv(x - x_r))


class GroupSA(nn.Module):
    """Grouped self-attention with tied Q/K weights, ``(B, N, C) ->
    (B, N, C)``: the grouped projection ``qk_conv`` serves as both queries
    and keys (the reference ties ``q_conv.weight = k_conv.weight``). At a
    compute ``dtype`` the input is cast to it and so is the output."""

    def __init__(self, channels: int, gp: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.qk_conv = GroupedDense(channels, gp, dtype)
        self.v_conv = Dense(channels, channels, dtype=dtype)
        self.trans_conv = Dense(channels, channels, dtype=dtype)
        self.after_norm = BatchNorm(channels)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return _tied_attention(x, self.qk_conv(x), self.v_conv(x), self.trans_conv, self.after_norm)


class SA(nn.Module):
    """Ungrouped self-attention with tied Q/K (reference ``SALayer``):
    ``qk_conv`` is a bias-free ``Linear``. Nothing in the JAX package
    calls it."""

    def __init__(self, channels: int):
        super().__init__()
        self.qk_conv = nn.Linear(channels, channels, bias=False)
        self.v_conv = nn.Linear(channels, channels)
        self.trans_conv = nn.Linear(channels, channels)
        self.after_norm = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _tied_attention(x, self.qk_conv(x), self.v_conv(x), self.trans_conv, self.after_norm)
