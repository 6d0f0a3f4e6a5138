"""NetVLAD aggregation heads.

Port of ``patchaugnet_tpu/nn/vlad.py``: ``NetVLADBase``, ``GatingContext``
and PatchAugNet's ``SpatialPyramidNetVLAD`` (reference
``loupe.py:159-361``) with all six aggregation types (0=FC, 1/4/5=AFA
combos, 2=APFA2, the paper's, 3=max-pool); PPT-Net's
``PPTSpatialPyramidNetVLAD`` (pptnet ``loupe.py:73-105``) and
PointNetVLAD's ``NetVLADLoupe`` (``PointNetVlad.py:12-81``). Inputs are
channels-last ``(B, N, C)`` point features.

A raw weight whose JAX initialiser takes another fan than its
second-to-last axis names it in ``init_fan`` (``nn.seeded_init_``): the
FC weights of the last two heads have std ``1/sqrt(feature_size)``.

A compute ``dtype`` (bf16) applies to the VLAD cores' two N-sized
products only: their inputs are rounded to it and the products are
accumulated and returned in f32 (the JAX einsums'
``preferred_element_type=float32``), here as f32 products of the rounded
operands; the softmax, the residual subtraction, the norms and every head
after the cores stay f32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .attention import AdaptiveFeatureAggregator
from .core import BatchNorm, group_sum, l2_normalize


def _flatten_ck(v: torch.Tensor) -> torch.Tensor:
    """``(B, C, K) -> (B, C*K)`` in the reference's channel-major order."""
    return v.reshape(v.shape[0], -1)


def _rounded(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held in f32 (``t`` itself without a
    dtype): an f32 product of such operands is the low-precision product
    with f32 accumulation."""
    return t if dtype is None else t.to(dtype).to(torch.float32)


class NetVLADBase(nn.Module):
    """Soft-assignment VLAD: ``(B, N, C) -> (B, C, K)`` in f32, intra-normalised over C."""

    def __init__(self, feature_size: int, cluster_size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cluster_weights = nn.Parameter(torch.empty(feature_size, cluster_size))
        self.cluster_weights2 = nn.Parameter(torch.empty(1, feature_size, cluster_size))
        self.bn1 = BatchNorm(cluster_size)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group``: the process group over which the N axis of ``x`` is
        split (point-axis sharding, ``parallel.sharded_model``); the two
        N-sums are then summed over it (the JAX ``psum_axis``)."""
        xc = _rounded(x, self.compute_dtype)
        activation = self.bn1(torch.einsum("bnc,ck->bnk", xc, _rounded(self.cluster_weights, self.compute_dtype)))
        activation = torch.softmax(activation, dim=-1)     # (B, N, K)
        a_sum = activation.sum(dim=1, keepdim=True)        # (B, 1, K)
        vlad = torch.einsum("bnk,bnc->bck", _rounded(activation, self.compute_dtype), xc)
        if group is not None:
            a_sum, vlad = group_sum(a_sum, group), group_sum(vlad, group)
        vlad = vlad - a_sum * self.cluster_weights2        # (B, C, K)
        return l2_normalize(vlad, dim=1)


class GatingContext(nn.Module):
    """Context gating over a ``(B, D)`` descriptor: ``x * sigmoid(bn1(x W))``,
    or ``x * sigmoid(x W + gating_biases)`` without the BatchNorm."""

    def __init__(self, dim: int, add_batch_norm: bool = True):
        super().__init__()
        self.gating_weights = nn.Parameter(torch.empty(dim, dim))
        if add_batch_norm:
            self.bn1 = BatchNorm(dim)
        else:
            self.gating_biases = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gates = x @ self.gating_weights
        if hasattr(self, "bn1"):
            gates = self.bn1(gates)
        else:
            gates = gates + self.gating_biases
        return x * torch.sigmoid(gates)


class SpatialPyramidNetVLAD(nn.Module):
    """Multi-scale VLAD with six aggregation modes (PatchAugNet variant).

    Takes per-scale point features ``[(B, N_i, C_i)]`` and returns
    ``(B, output_dim[0])``. ``dtype`` is the VLAD cores'.
    """

    def __init__(
        self,
        feature_size: Sequence[int],
        cluster_size: Sequence[int],
        output_dim: Sequence[int],
        gating: bool = False,
        aggregation_type: int = 2,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if aggregation_type not in range(6):
            raise ValueError(f"unknown aggregation_type {aggregation_type}")
        self.aggregation_type = t = aggregation_type
        self.gating = gating
        self.scales = s = len(feature_size)
        for i in range(s):
            setattr(self, f"vlad{i}", NetVLADBase(feature_size[i], cluster_size[i], dtype))
        sum_k = sum(cluster_size)
        c0, d0 = feature_size[0], output_dim[0]
        if t in (1, 4):
            for i in range(s):
                setattr(self, f"afa_scale{i}", AdaptiveFeatureAggregator(
                    output_dim[i], cluster_size[i], output_dim[i]))
        if t == 0:
            self.hidden_weights = nn.Parameter(torch.empty(c0 * sum_k, d0))
            self.bn = BatchNorm(d0)
        elif t in (1, 5):
            self.afa = AdaptiveFeatureAggregator(d0, s, d0)
        elif t == 2:
            self.afa = AdaptiveFeatureAggregator(d0, sum_k, d0)
        elif t == 4:
            self.hidden_weights = nn.Parameter(torch.empty(c0 * s, d0))
            self.bn = BatchNorm(d0)
        if t == 5:
            for i in range(s):
                setattr(self, f"hidden_weights{i}", nn.Parameter(
                    torch.empty(feature_size[i] * cluster_size[i], output_dim[i])))
                setattr(self, f"bn{i}", BatchNorm(output_dim[i]))
        if gating:
            self.context_gating = GatingContext(d0)

    def forward(self, features: List[torch.Tensor], groups: Optional[Sequence] = None) -> torch.Tensor:
        """``groups``: per scale, the process group that splits its N axis
        (``NetVLADBase``'s ``group``) or None (the JAX ``psum_axes``)."""
        if len(features) != self.scales:
            raise ValueError(f"expected {self.scales} scales, got {len(features)}")
        groups = groups or [None] * self.scales
        v_list = [getattr(self, f"vlad{i}")(f, groups[i]) for i, f in enumerate(features)]   # [(B, C, K_i)]
        t = self.aggregation_type
        if t == 0:
            v = torch.cat(v_list, dim=-1)                   # (B, C, sumK)
            vlad = l2_normalize(self.bn(_flatten_ck(v) @ self.hidden_weights), dim=-1)
        elif t == 1:
            scaled = [getattr(self, f"afa_scale{i}")(v.transpose(-1, -2))[:, None, :]
                      for i, v in enumerate(v_list)]        # [(B, 1, C)]
            vlad = self.afa(torch.cat(scaled, dim=1))
        elif t == 2:
            v = torch.cat(v_list, dim=-1)                   # (B, C, sumK)
            vlad = self.afa(v.transpose(-1, -2))
        elif t == 3:
            v = torch.cat(v_list, dim=-1)
            vlad = l2_normalize(v.amax(dim=-1), dim=-1)     # (B, C)
        elif t == 4:
            scaled = [getattr(self, f"afa_scale{i}")(v.transpose(-1, -2))[:, :, None]
                      for i, v in enumerate(v_list)]        # [(B, C, 1)]
            v = torch.cat(scaled, dim=-1)                   # (B, C, S)
            vlad = l2_normalize(self.bn(_flatten_ck(v) @ self.hidden_weights), dim=-1)
        else:
            per_scale = []
            for i, v in enumerate(v_list):
                h = _flatten_ck(v) @ getattr(self, f"hidden_weights{i}")
                h = getattr(self, f"bn{i}")(h)
                per_scale.append(l2_normalize(h, dim=-1)[:, None, :])
            vlad = self.afa(torch.cat(per_scale, dim=1))    # (B, S, C) -> (B, C)
        if self.gating:
            vlad = self.context_gating(vlad)
        return vlad


class PPTSpatialPyramidNetVLAD(nn.Module):
    """PPT-Net's multi-scale VLAD: ``[(B, N_i, C_i)] -> (B, output_dim[0])``.

    Each scale's VLAD ``vlad{i}`` flattened channel-major to ``(B, C*K_i)``,
    the scales concatenated, one product with ``hidden_weights`` of shape
    ``(C_0 * sum(K), D_0)``, the BatchNorm ``bn2``, and context gating when
    ``gating``. ``dtype`` is the VLAD cores'.
    """

    def __init__(self, feature_size: Sequence[int], cluster_size: Sequence[int], output_dim: Sequence[int],
                 gating: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scales = len(feature_size)
        for i in range(self.scales):
            setattr(self, f"vlad{i}", NetVLADBase(feature_size[i], cluster_size[i], dtype))
        c0, d0 = feature_size[0], output_dim[0]
        self.hidden_weights = nn.Parameter(torch.empty(c0 * sum(cluster_size), d0))
        self.init_fan = {"hidden_weights": c0}
        self.bn2 = BatchNorm(d0)
        self.context_gating = GatingContext(d0) if gating else None

    def forward(self, features: List[torch.Tensor], groups: Optional[Sequence] = None) -> torch.Tensor:
        """``groups`` as ``SpatialPyramidNetVLAD``'s."""
        if len(features) != self.scales:
            raise ValueError(f"expected {self.scales} scales, got {len(features)}")
        groups = groups or [None] * self.scales
        flats = [_flatten_ck(getattr(self, f"vlad{i}")(f, groups[i])) for i, f in enumerate(features)]
        vlad = self.bn2(torch.cat(flats, dim=-1) @ self.hidden_weights)
        if self.context_gating is not None:
            vlad = self.context_gating(vlad)
        return vlad


class NetVLADLoupe(nn.Module):
    """PointNetVLAD's head, ``(B, N, C) -> (B, output_dim)``: the VLAD
    ``base`` (intra-normalised), a channel-major flatten, a global L2 norm,
    the product with ``hidden1_weights`` of shape ``(K*C, D)``, the
    BatchNorm ``bn2``, and context gating when ``gating``. ``dtype`` is the
    VLAD core's."""

    def __init__(self, feature_size: int, cluster_size: int, output_dim: int, gating: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.base = NetVLADBase(feature_size, cluster_size, dtype)
        self.hidden1_weights = nn.Parameter(torch.empty(cluster_size * feature_size, output_dim))
        self.init_fan = {"hidden1_weights": feature_size}
        self.bn2 = BatchNorm(output_dim)
        self.context_gating = GatingContext(output_dim) if gating else None

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group`` as ``NetVLADBase``'s."""
        flat = l2_normalize(_flatten_ck(self.base(x, group)), dim=-1)
        out = self.bn2(flat @ self.hidden1_weights)
        if self.context_gating is not None:
            out = self.context_gating(out)
        return out
