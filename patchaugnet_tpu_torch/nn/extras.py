"""Auxiliary NN blocks (rerank and pose-estimation support library).

Port of ``patchaugnet_tpu/nn/extras.py`` (reference ``utils/model_util/*``),
channels-last ``(B, L, C)`` sequences:

  - :class:`SEAttention`, :class:`ChannelAttention`,
    :class:`SpatialAttention`, :class:`CBAM` (``attention.py:6-97``);
  - :class:`GeMPooling` (``pool.py:5-21``) and
    :func:`sinusoidal_positional_embedding` (``position_embedding.py:5-32``);
  - :class:`MultiheadAttention` (optionally Linformer-style, keys and
    values projected along the sequence to ``proj_k``) and
    :class:`TransformerEncoderLayer` (``transformer.py:19-102``,
    ``linear_multihead_attention.py:323-495``);
  - :class:`AttentionalGNN` (SuperGlue-style self/cross message passing);
  - the geometric encoders :func:`nn_angle`, :class:`AbsCoordEncoder`,
    :class:`DistanceEncoder`, :class:`AngleEncoder`, :class:`GeoEncoder`;
  - :class:`SingleFeatProcessor` and :class:`PairwiseFeatProcessor`
    (``feat_processor.py:191-353``).

Attribute names follow the flax variable tree, flax's automatic names
included (``Dense_0``, ``LayerNorm_0``), so ``compat.load_jax_variables``
carries the JAX weights over. Layers whose JAX ``Dense`` acts along the
sequence axis (the Linformer projections, the distance and angle encoders)
take the sequence length as a constructor argument, since torch's
``Linear`` is not shaped lazily. flax's ``LayerNorm`` has eps 1e-6,
torch's 1e-5: every ``LayerNorm`` here takes 1e-6. Attention is
``einsum`` and ``softmax``, as the JAX module computes it. Train mode
(``module.train()``) is flax's ``train=True``: dropout and the batch
statistics of CBAM's BatchNorm.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import ops
from .core import BatchNorm
from .vlad import NetVLADBase

LN_EPS = 1e-6   # flax nn.LayerNorm's epsilon


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: each element kept with
    probability ``1 - rate`` (drawn from ``generator``, on ``x``'s device,
    or the default generator) and scaled by ``1 / (1 - rate)``."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class SEAttention(nn.Module):
    """Squeeze-and-excitation over the channels of ``(B, L, C)``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=1)))))
        return x * y[:, None, :]


class ChannelAttention(nn.Module):
    """CBAM channel attention (``attention.py:39-58``): one MLP over the
    mean- and max-pooled channel vectors."""

    def __init__(self, channels: int, ratio: int = 8):
        super().__init__()
        self.mlp1 = nn.Linear(channels, channels // ratio, bias=False)
        self.mlp2 = nn.Linear(channels // ratio, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = self.mlp2(torch.relu(self.mlp1(x.mean(dim=1))))
        mx = self.mlp2(torch.relu(self.mlp1(x.amax(dim=1))))
        return x * torch.sigmoid(avg + mx)[:, None, :]


class SpatialAttention(nn.Module):
    """CBAM spatial attention (``attention.py:61-85``): the channels' [max,
    mean] -> a 1x1 conv -> BatchNorm (flax momentum 0.99) -> ReLU ->
    softmax over positions. ``return_attn`` also returns the ``(B, L, 1)``
    weights."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Linear(2, 1, bias=False)
        self.bn = BatchNorm(1, momentum=0.99)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        stats = torch.stack([x.amax(dim=-1), x.mean(dim=-1)], dim=-1)   # (B, L, 2)
        att = self.bn.relu(self.conv1(stats))                           # (B, L, 1)
        att = torch.softmax(att[..., 0], dim=-1)[..., None]
        out = att * x
        return (out, att) if return_attn else out


class CBAM(nn.Module):
    def __init__(self, channels: int, ratio: int = 8):
        super().__init__()
        self.channel = ChannelAttention(channels, ratio)
        self.spatial = SpatialAttention()

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        return self.spatial(self.channel(x), return_attn=return_attn)


class GeMPooling(nn.Module):
    """Generalised-mean pooling over the positions of ``(B, L, C)``
    (``pool.py:5-21``; a fixed ``p``, unlike MinkLoc's learned one)."""

    def __init__(self, p: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p, self.eps = p, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.clamp_min(self.eps) ** self.p).mean(dim=1) ** (1.0 / self.p)


def sinusoidal_positional_embedding(indices: torch.Tensor, d_model: int) -> torch.Tensor:
    """``(*,) -> (*, d_model)`` sin/cos embedding, interleaved [sin, cos]
    per frequency (``position_embedding.py:25-31``)."""
    if d_model % 2:
        raise ValueError(f"d_model={d_model}: the embedding interleaves sin and cos, so it must be even")
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=indices.device)
                    * (-math.log(10000.0) / d_model))
    omega = indices[..., None].to(torch.float32) * div      # (*, d/2)
    return torch.stack([torch.sin(omega), torch.cos(omega)], dim=-1).reshape(*indices.shape, d_model)


class MultiheadAttention(nn.Module):
    """Standard or Linformer-style multi-head attention over ``(B, L, C)``.

    With ``proj_k`` the keys and values are projected along the sequence
    axis from ``seq_len`` (the key length, which the projections' weights
    are tied to) to ``proj_k`` positions, and the mask is dropped. A mask
    ``(B, Lk)`` (True = attend) sets the other logits to -1e30.
    """

    def __init__(self, d_model: int, nhead: int, proj_k: Optional[int] = None, seq_len: Optional[int] = None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        if proj_k is not None:
            if seq_len is None:
                raise ValueError("MultiheadAttention: proj_k needs seq_len, the key length its projections take")
            self.e_proj = nn.Linear(seq_len, proj_k)
            self.f_proj = nn.Linear(seq_len, proj_k)
        self.proj_k = proj_k
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        d_head = self.d_model // self.nhead
        wq, wk, wv = self.q(q), self.k(k), self.v(v)
        if self.proj_k is not None:
            wk = self.e_proj(wk.transpose(1, 2)).transpose(1, 2)
            wv = self.f_proj(wv.transpose(1, 2)).transpose(1, 2)
            mask = None                                    # undefined after the projection
        b, lq, _ = wq.shape
        lk = wk.shape[1]
        wq = wq.reshape(b, lq, self.nhead, d_head)
        wk = wk.reshape(b, lk, self.nhead, d_head)
        wv = wv.reshape(b, lk, self.nhead, d_head)
        logits = torch.einsum("bqhd,bkhd->bhqk", wq, wk) / math.sqrt(d_head)
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits, -1e30)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, wv).reshape(b, lq, self.d_model)
        return self.out(out)


class TransformerEncoderLayer(nn.Module):
    """DETR-style encoder layer with an optional positional embedding added
    to queries and keys and optional Linformer attention
    (``transformer.py:19-102``; ``seq_len`` as :class:`MultiheadAttention`
    takes it). In train mode dropout draws from ``generator`` (on the
    input's device) or the default generator."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048, dropout: float = 0.1,
                 linear_attention_k: Optional[int] = None, seq_len: Optional[int] = None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, proj_k=linear_attention_k, seq_len=seq_len)
        self.norm1 = _layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = _layer_norm(d_model)

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return _dropout(x, self.dropout, generator) if self.training else x

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        qk = src if pos is None else src + pos
        src = self.norm1(src + self._drop(self.self_attn(qk, qk, src, mask), generator))
        ff = self._drop(torch.relu(self.linear1(src)), generator)
        return self.norm2(src + self._drop(self.linear2(ff), generator))


def _instance_norm_seq(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free InstanceNorm over the sequence axis of ``(B, N, C)``
    with the biased variance (the reference MLP's ``nn.InstanceNorm1d``,
    ``feat_processor.py:13-25``)."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class _MessageMLP(nn.Module):
    """The AttentionalPropagation message MLP [2d, 2d, d] with
    InstanceNorm + ReLU between its layers (``feat_processor.py:13-25, 55-63``)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.fc0 = nn.Linear(2 * d_model, 2 * d_model)
        self.fc1 = nn.Linear(2 * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(torch.relu(_instance_norm_seq(self.fc0(x))))


class AttentionalGNN(nn.Module):
    """SuperGlue-style alternating self/cross attention over two point
    sets, with residual MLP-message updates. A layer's attention and
    message MLP serve both streams. With all-'self' layers the two streams
    are independent (pass one set twice for the reference's self-only
    mode, ``feat_processor.py:80-89``)."""

    def __init__(self, d_model: int, nhead: int = 4, layer_types: Sequence[str] = ("self", "cross", "self", "cross")):
        super().__init__()
        self.layer_types = tuple(layer_types)
        for i in range(len(self.layer_types)):
            setattr(self, f"attn{i}", MultiheadAttention(d_model, nhead))
            setattr(self, f"mlp{i}", _MessageMLP(d_model))

    def forward(self, x0: torch.Tensor, x1: torch.Tensor):
        for i, kind in enumerate(self.layer_types):
            attn, mlp = getattr(self, f"attn{i}"), getattr(self, f"mlp{i}")
            if kind == "self":
                m0, m1 = attn(x0, x0, x0), attn(x1, x1, x1)
            else:
                m0, m1 = attn(x0, x1, x1), attn(x1, x0, x0)
            x0, x1 = x0 + mlp(torch.cat([x0, m0], dim=-1)), x1 + mlp(torch.cat([x1, m1], dim=-1))
        return x0, x1


# ------------------------------------------------- geometric encoders
def nn_angle(c: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Cosine of the angles between each point's edge to every other point
    and its k nearest-neighbour edges (the JAX package's ``nn_angle_jax``,
    reference ``utils/train_util.py:242-277``). The neighbours are
    ``ops.knn`` at k + 1 without its first rank: one K2 launch on the card.

    Args: c ``(b, m, 3)``. Returns ``(b, k, m, m)``.
    """
    idx, _ = ops.knn(c, None, k + 1)
    c2 = ops.group(c, idx[..., 1:])                         # (b, m, k, 3)
    c01 = c[:, None, :, :] - c[:, :, None, :]               # (b, m, m, 3)
    c02 = c2 - c[:, :, None, :]                             # (b, m, k, 3)
    c01n = c01 / torch.linalg.vector_norm(c01, dim=-1, keepdim=True).clamp_min(1e-8)
    c02n = c02 / torch.linalg.vector_norm(c02, dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.einsum("bmkd,bmjd->bkmj", c02n, c01n)


class AbsCoordEncoder(nn.Module):
    """``(B, N, 3) -> (B, N, d)`` (``feat_processor.py:105-120``)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(3, embed_dim)
        self.LayerNorm_0 = _layer_norm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.LayerNorm_0(self.Dense_0(x)))


class DistanceEncoder(nn.Module):
    """All-pairs-distance row embedding (``feat_processor.py:120-139``) of
    ``(B, N, 3)`` centred points: each point's row of N distances, clamped
    at ``max_dist`` when given and divided by the largest distance in the
    whole batch, through a ``Dense`` of ``num_points`` inputs."""

    def __init__(self, embed_dim: int, num_points: int, max_dist: Optional[float] = None):
        super().__init__()
        self.max_dist = max_dist
        self.Dense_0 = nn.Linear(num_points, embed_dim)
        self.LayerNorm_0 = _layer_norm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        centered = x - x.mean(dim=1, keepdim=True)
        d = torch.sqrt(((centered[:, :, None, :] - centered[:, None, :, :]) ** 2).sum(-1).clamp_min(0.0))
        if self.max_dist is not None:
            d = d.clamp_max(self.max_dist)
        d = d / d.amax().clamp_min(1e-8)
        return torch.relu(self.LayerNorm_0(self.Dense_0(d)))


class AngleEncoder(nn.Module):
    """kNN-edge angle embedding of ``(B, N, 3)`` points, max-pooled over the
    k edges (``feat_processor.py:142-164``): :func:`nn_angle` rows of
    ``num_points`` cosines through a ``Dense``."""

    def __init__(self, embed_dim: int, num_points: int, angle_k: int = 3):
        super().__init__()
        self.angle_k = angle_k
        self.Dense_0 = nn.Linear(num_points, embed_dim)
        self.LayerNorm_0 = _layer_norm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = nn_angle(x, self.angle_k)                       # (b, k, m, m)
        a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.relu(self.LayerNorm_0(self.Dense_0(a))).amax(dim=1)   # (b, m, d)


class GeoEncoder(nn.Module):
    """Geometric structure encoder by ``encode_type``
    (``feat_processor.py:167-188``): ``abs_coord``, ``nn_dist``,
    ``nn_angle``, anything else distance + angle. ``num_points`` is the
    sequence length the distance and angle encoders take."""

    def __init__(self, encode_type: str, element_dim: int, num_points: int, angle_k: int = 3):
        super().__init__()
        if encode_type == "abs_coord":
            self.encoder = AbsCoordEncoder(element_dim)
        elif encode_type == "nn_dist":
            self.encoder = DistanceEncoder(element_dim, num_points)
        elif encode_type == "nn_angle":
            self.encoder = AngleEncoder(element_dim, num_points, angle_k)
        else:
            self.geo_encoder = DistanceEncoder(element_dim, num_points)
            self.angle_encoder = AngleEncoder(element_dim, num_points, angle_k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "encoder"):
            return self.encoder(x)
        return self.geo_encoder(x) + self.angle_encoder(x)


# ------------------------------------------------------ feat processors
def _pool_seq(x: torch.Tensor, pool: str) -> torch.Tensor:
    """avg / max / gem over the sequence axis of ``(B, N, C)`` -> ``(B, C)``
    (``pool.py:23-31``)."""
    if pool == "avg":
        return x.mean(dim=1)
    if pool == "max":
        return x.amax(dim=1)
    if pool == "gem":
        return (x.clamp_min(1e-6) ** 3.0).mean(dim=1) ** (1.0 / 3.0)
    raise ValueError(f"not support pooling way: {pool}")


class _FeatProcessorCore(nn.Module):
    """What Single/PairwiseFeatProcessor share (``feat_processor.py:191-353``):
    geo-encode the positions into the local features, add or concatenate
    the global feature, embed, optionally aggregate with NetVLAD, interact
    through the GNN, optionally pool.

    ``config`` keys: ``embed_dim``, ``local_dim``, ``global_dim``,
    ``num_local`` (the sequence length), ``cluster_size``,
    ``use_geo_encoder``, ``geo_encode_type``, ``angle_k`` (default 3),
    ``add_or_cat`` (``add``, ``cat`` or neither), ``use_vlad``,
    ``layer_names``, ``use_pool``, ``pool``. The JAX processor calls its
    NetVLAD without ``train``, so its BatchNorm always normalises with the
    running statistics: ``train()`` leaves ``vlad`` in eval mode.
    """

    def __init__(self, config: dict):
        super().__init__()
        cfg = self.config = dict(config)
        if cfg["embed_dim"] % 2:
            raise ValueError(f"embed_dim={cfg['embed_dim']}: must be even")
        if cfg["use_geo_encoder"]:
            self.geo_encoder = GeoEncoder(cfg["geo_encode_type"], cfg["local_dim"], cfg["num_local"],
                                          cfg.get("angle_k", 3))
        width = cfg["global_dim"] + cfg["local_dim"] if cfg["add_or_cat"] == "cat" else cfg["local_dim"]
        self.mlp_fc = nn.Linear(width, cfg["embed_dim"])
        self.mlp_ln = _layer_norm(cfg["embed_dim"])
        if cfg["use_vlad"]:
            self.vlad = NetVLADBase(feature_size=cfg["embed_dim"], cluster_size=cfg["cluster_size"])
        if len(cfg["layer_names"]) > 0:
            self.norm1 = _layer_norm(cfg["embed_dim"])
            self.gnn_layer = AttentionalGNN(cfg["embed_dim"], nhead=4, layer_types=tuple(cfg["layer_names"]))
        self.train()

    def train(self, mode: bool = True):
        super().train(mode)
        if hasattr(self, "vlad"):
            self.vlad.eval()
        return self

    @property
    def out_dim(self) -> int:
        cfg = self.config
        if cfg["use_pool"]:
            return cfg["embed_dim"]
        n = cfg["cluster_size"] if cfg["use_vlad"] else cfg["num_local"]
        return n * cfg["embed_dim"]

    def _embed(self, x_global, x_local, x_position):
        cfg = self.config
        if cfg["use_geo_encoder"]:
            x_local = x_local + self.geo_encoder(x_position)
        if cfg["add_or_cat"] == "add":
            feat = x_global[:, None, :] + x_local
        elif cfg["add_or_cat"] == "cat":
            g = x_global[:, None, :].expand(*x_local.shape[:2], x_global.shape[-1])
            feat = torch.cat([g, x_local], dim=-1)
        else:
            feat = x_local
        feat = torch.relu(self.mlp_ln(self.mlp_fc(feat)))
        if cfg["use_vlad"]:
            feat = self.vlad(feat).transpose(1, 2)          # (B, C, K) -> (B, K, C)
        return feat

    def _finish(self, feat):
        if self.config["use_pool"]:
            return _pool_seq(feat, self.config["pool"])
        return feat


class SingleFeatProcessor(_FeatProcessorCore):
    """``(x_global (B, D), x_local (B, N, D), x_position (B, N, 3)) ->
    (B, embed_dim)`` pooled or ``(B, n, embed_dim)``
    (``feat_processor.py:191-262``); self-attention interaction only."""

    def forward(self, x_global, x_local, x_position):
        feat = self._embed(x_global, x_local, x_position)
        if len(self.config["layer_names"]) > 0:
            feat = self.norm1(feat)
            feat, _ = self.gnn_layer(feat, feat)
        return self._finish(feat)


class PairwiseFeatProcessor(_FeatProcessorCore):
    """The two-cloud variant: shared weights and, with 'cross' layers,
    cross attention between the sets (``feat_processor.py:265-353``)."""

    def forward(self, x_global, x_local, x_position, y_global, y_local, y_position):
        xf = self._embed(x_global, x_local, x_position)
        yf = self._embed(y_global, y_local, y_position)
        if len(self.config["layer_names"]) > 0:
            xf, yf = self.gnn_layer(self.norm1(xf), self.norm1(yf))
        return self._finish(xf), self._finish(yf)
