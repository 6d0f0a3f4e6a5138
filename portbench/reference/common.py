"""Plain PyTorch arithmetic shared by the reference models.

Written from the published models (the PatchAugNet repository's
``place_recognition`` models and ``utils/pt_util.py``), channels-last, in
float32, with no kernel, cache or fused operator: farthest point sampling
as a loop of distance updates and arg-maxes, the kNN as a stable sort of
the full distance matrix (so the lowest index wins a tie), BatchNorm as
its formula. Parameters and BatchNorm statistics come in by name in a
dict; a train-mode forward records each BatchNorm's new running
statistics in :attr:`Net.updates` and leaves the dict as it was.

``Net(tf32=True)`` is the control: every matrix product takes operands
rounded to TF32's 10-bit mantissa, as the card's tensor cores take them
when TF32 is on; in a backward, the gradient reaching each operand is
rounded the same way.

This file imports nothing of the package under test.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9          # running = 0.9 running + 0.1 batch
KNN_BLOCK_ELEMENTS = 1 << 27   # distance-matrix entries sorted at once


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 mantissa bits), held in f32."""
    bits = x.detach().to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    """A product's operand in TF32; its gradient rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return to_tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return to_tf32(grad)


class Net:
    """One forward's parameters, mode and precision."""

    def __init__(self, params: Dict[str, torch.Tensor], train: bool = False, tf32: bool = False):
        self.p, self.train, self.tf32 = params, train, tf32
        self.updates: Dict[str, torch.Tensor] = {}

    # products -------------------------------------------------------------
    def _r(self, t: torch.Tensor) -> torch.Tensor:
        return _TF32.apply(t) if self.tf32 else t

    def linear(self, x: torch.Tensor, name: str, bias: bool = False) -> torch.Tensor:
        """``x W^T (+ b)`` with ``W = p[name.weight]`` of shape (out, in)."""
        b = self.p[f"{name}.bias"] if bias else None
        return F.linear(self._r(x), self._r(self.p[f"{name}.weight"]), b)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self._r(a), self._r(b))

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self._r(a), self._r(b))

    # normalisation ----------------------------------------------------------
    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """BatchNorm over the last axis: ``(x - mean) * (rsqrt(var + eps) * w) + b``;
        train mode takes the biased batch statistics over every leading axis."""
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if not self.train:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
            return (x - mean) * (torch.rsqrt(var + BN_EPS) * w) + b
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
        with torch.no_grad():
            for stat, batch in (("running_mean", mean), ("running_var", var)):
                key = f"{name}.{stat}"
                self.updates[key] = BN_MOMENTUM * self.p[key] + (1 - BN_MOMENTUM) * batch.detach()
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * w) + b

    def shared_mlp(self, x: torch.Tensor, name: str, depth: int) -> torch.Tensor:
        for i in range(depth):
            x = torch.relu(self.bn(self.linear(x, f"{name}.layer{i}"), f"{name}.bn{i}"))
        return x


def l2n(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)


# geometry (no gradient flows through indices) -------------------------------
def sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(b, n, 3), (b, m, 3) -> (b, n, m)``: ((0 + dx^2) + dy^2) + dz^2, clamped at 0."""
    d = torch.zeros((x.shape[0], x.shape[1], y.shape[1]), dtype=torch.float32, device=x.device)
    for c in range(3):
        diff = x[:, :, None, c] - y[:, None, :, c]
        d = d + diff * diff
    return d.clamp_min(0.0)


@torch.no_grad()
def fps(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """Farthest point sampling: first pick 0, then the first arg-max of the
    running min-distance (started at 1e10). ``(b, m)`` int64."""
    b, n, _ = xyz.shape
    idx = torch.zeros((b, m), dtype=torch.int64, device=xyz.device)
    min_d = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    for i in range(1, m):
        pt = xyz[rows, last]
        d = torch.zeros((b, n), dtype=torch.float32, device=xyz.device)
        for c in range(3):
            diff = xyz[:, :, c] - pt[:, None, c]
            d = d + diff * diff
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        idx[:, i] = last
    return idx


@torch.no_grad()
def knn(xyz: torch.Tensor, query: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest of ``xyz`` to each query, ascending, the lowest index on
    ties: ``(idx (b, m, k) int64, squared distances)``, sorted in blocks of clouds."""
    b, m, n = xyz.shape[0], query.shape[1], xyz.shape[1]
    step = max(1, KNN_BLOCK_ELEMENTS // max(m * n, 1))
    idx, d2 = [], []
    for s in range(0, b, step):
        d = sqdist(query[s:s + step], xyz[s:s + step])
        order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
        idx.append(order)
        d2.append(torch.gather(d, -1, order))
    return torch.cat(idx), torch.cat(d2)


def gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, j..., c] = feats[b, idx[b, j...], c]`` for any index shape."""
    b = feats.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(feats, 1, flat[..., None].expand(b, flat.shape[1], feats.shape[-1]))
    return out.reshape(*idx.shape, feats.shape[-1])


def interpolate(unknown_xyz: torch.Tensor, known_xyz: torch.Tensor, known_feats: torch.Tensor) -> torch.Tensor:
    """3-NN inverse-distance interpolation, summed in neighbour order."""
    idx, d2 = knn(known_xyz, unknown_xyz, 3)
    recip = 1.0 / (torch.sqrt(d2) + 1e-8)
    weight = recip / recip.sum(-1, keepdim=True)
    out = None
    for j in range(3):
        term = gather(known_feats, idx[..., j]) * weight[..., j:j + 1]
        out = term if out is None else out + term
    return out


# PointNet++ levels ----------------------------------------------------------
def sa_level(net: Net, name: str, xyz: torch.Tensor, feats: torch.Tensor, npoint: int, nsample: int,
             depth: int, attention_groups: Optional[int] = None):
    """FPS -> kNN -> EdgeConv group (centred xyz ++ centred features) ->
    shared MLP -> neighbour max-pool (-> grouped self-attention).
    Returns ``(new_xyz, features, centre idx, neighbour idx)``."""
    center = fps(xyz, npoint)
    new_xyz = gather(xyz, center)
    center_feats = gather(feats, center)
    idx, _ = knn(xyz, new_xyz, nsample)
    grouped_xyz = gather(xyz, idx) - new_xyz[:, :, None, :]
    grouped = gather(feats, idx)
    if nsample > 1:
        grouped = grouped - center_feats[:, :, None, :]
    h = net.shared_mlp(torch.cat([grouped_xyz, grouped], dim=-1), f"{name}.mlp", depth).amax(dim=2)
    if attention_groups is not None:
        h = group_self_attention(net, f"{name}.sa", h, attention_groups)
    return new_xyz, h, center, idx


def fp_level(net: Net, name: str, unknown_xyz, known_xyz, unknown_feats, known_feats, depth: int):
    h = interpolate(unknown_xyz, known_xyz, known_feats)
    if unknown_feats is not None:
        h = torch.cat([h, unknown_feats], dim=-1)
    return net.shared_mlp(h, f"{name}.mlp", depth)


def group_self_attention(net: Net, name: str, x: torch.Tensor, gp: int) -> torch.Tensor:
    """PPT-Net's grouped self-attention with tied queries and keys: energy
    ``q q^T``, softmax over keys, each column divided by ``1e-9 +`` its sum,
    ``x + relu(bn(W_t (x - attn^T v) + b_t))``."""
    c = x.shape[-1]
    kernel = net.p[f"{name}.qk_conv.kernel"]                  # (gp, c/gp, c/gp)
    q = net.einsum("...gi,gio->...go", x.reshape(*x.shape[:-1], gp, c // gp), kernel).reshape(x.shape)
    v = net.linear(x, f"{name}.v_conv", bias=True)
    attn = torch.softmax(net.bmm(q, q.transpose(1, 2)), dim=-1)
    attn = attn / (1e-9 + attn.sum(dim=1, keepdim=True))
    x_r = net.bmm(attn.transpose(1, 2), v)
    return x + torch.relu(net.bn(net.linear(x - x_r, f"{name}.trans_conv", bias=True), f"{name}.after_norm"))


# aggregation -----------------------------------------------------------------
def netvlad(net: Net, name: str, x: torch.Tensor) -> torch.Tensor:
    """Soft-assignment VLAD ``(B, N, C) -> (B, C, K)``, intra-normalised over C."""
    act = torch.softmax(net.bn(net.einsum("bnc,ck->bnk", x, net.p[f"{name}.cluster_weights"]), f"{name}.bn1"),
                        dim=-1)
    vlad = net.einsum("bnk,bnc->bck", act, x) - act.sum(dim=1, keepdim=True) * net.p[f"{name}.cluster_weights2"]
    return l2n(vlad, dim=1)


def afa(net: Net, name: str, x: torch.Tensor) -> torch.Tensor:
    """Adaptive feature aggregation ``(B, K, C) -> (B, C_out)``: a softmax over
    the K slots of the channel-max of one product, ``relu(x + x w)``, the
    channel-major flatten, FC, BatchNorm, L2 norm."""
    w = torch.softmax(net.linear(x, f"{name}.mlpa.mlp0").amax(dim=-1), dim=-1)
    x = torch.relu(x + x * w[..., None])
    flat = x.transpose(-1, -2).reshape(x.shape[0], -1)
    return l2n(net.bn(net.linear(flat, f"{name}.fc", bias=True), f"{name}.bn"))


def context_gating(net: Net, name: str, x: torch.Tensor) -> torch.Tensor:
    gates = net.bn(net.matmul(x, net.p[f"{name}.gating_weights"]), f"{name}.bn1")
    return x * torch.sigmoid(gates)


# the names and shapes a reference model takes ---------------------------------
def mlp_spec(name: str, widths: Sequence[int], in_w: int):
    out = []
    for i, w in enumerate(widths):
        out += [(f"{name}.layer{i}.weight", (w, in_w))] + bn_spec(f"{name}.bn{i}", w)
        in_w = w
    return out


def bn_spec(name: str, c: int):
    return [(f"{name}.{leaf}", (c,)) for leaf in ("weight", "bias", "running_mean", "running_var")]


def vlad_spec(name: str, c: int, k: int):
    return [(f"{name}.cluster_weights", (c, k)), (f"{name}.cluster_weights2", (1, c, k))] + bn_spec(f"{name}.bn1", k)
