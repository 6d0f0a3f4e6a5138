"""PointNet blocks (channels-last).

Port of ``patchaugnet_tpu/nn/pointnet.py``: the spatial transformer
``STN3D`` (reference ``pointnet_autoencoder.py:6-40``, and the
``use_bn=False`` variant of ``PointNetVlad.py:124-177``), the global
``PointNetEncoder`` and ``PointNetDecoder`` (``pointnet_autoencoder.py:43-111``,
the decoder being PatchAugNet's patch decoder) and the
``PointNetAutoencoder`` that joins them. Attribute names follow the JAX
variable tree (``conv1``, ``conv1_bn``, ``fc1``, ``bn1``, ...), so
``compat.load_jax_variables`` maps them as they stand.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .core import BatchNorm, group_max, l2_normalize


class PointNetDecoder(nn.Module):
    """FC decoder: ``(R, embedding) -> (R, num_points, output_channels)``,
    fc1 1024 -> BN -> ReLU -> fc2 1024 -> BN -> ReLU -> fc3 -> tanh."""

    def __init__(self, embedding_size: int, num_points: int, output_channels: int = 3):
        super().__init__()
        self.num_points, self.output_channels = num_points, output_channels
        self.fc1 = nn.Linear(embedding_size, 1024)
        self.bn1 = BatchNorm(1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.bn2 = BatchNorm(1024)
        self.fc3 = nn.Linear(1024, num_points * output_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.bn1.relu(self.fc1(z))
        h = self.bn2.relu(self.fc2(h))
        h = torch.tanh(self.fc3(h))
        return h.reshape(-1, self.num_points, self.output_channels)


def _dense_bn_relu(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    """``relu(name_bn(name(x)))``, without the BatchNorm where ``module``
    has none of that name."""
    h = getattr(module, name)(x)
    bn = getattr(module, f"{name}_bn", None)
    return bn.relu(h) if bn is not None else torch.relu(h)


class STN3D(nn.Module):
    """Spatial transformer: ``(B, N, k) -> (B, k, k)``.

    conv1 64 -> conv2 128 -> conv3 1024 (each a ``Linear`` with bias, then
    a BatchNorm when ``use_bn``, then ReLU), a max over the points, fc1 512
    and fc2 256 the same way, then ``fc3`` to ``k * k`` plus the identity.
    The JAX initialiser zeroes ``fc3``'s weight and bias (``zero_init``), so
    the first transform is the identity. It runs in f32 whatever its input's
    dtype (the transforms are geometry).
    """

    def __init__(self, k: int = 3, use_bn: bool = True):
        super().__init__()
        self.k = k
        width = k
        for name, f in (("conv1", 64), ("conv2", 128), ("conv3", 1024), ("fc1", 512), ("fc2", 256)):
            setattr(self, name, nn.Linear(width, f))
            if use_bn:
                setattr(self, f"{name}_bn", BatchNorm(f))
            width = f
        self.fc3 = nn.Linear(256, k * k)
        self.zero_init = ("fc3",)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group``: the process group over which the N axis of ``x`` is
        split (point-axis sharding, eval only); the max over the points is
        then taken over it."""
        h = x.to(torch.float32)
        for name in ("conv1", "conv2", "conv3"):
            h = _dense_bn_relu(self, name, h)
        h = h.amax(dim=1)                                   # (B, 1024)
        if group is not None:
            h = group_max(h, group)
        for name in ("fc1", "fc2"):
            h = _dense_bn_relu(self, name, h)
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(-1)
        return (self.fc3(h) + eye).reshape(-1, self.k, self.k)


class PointNetEncoder(nn.Module):
    """Global PointNet encoder: ``(B, N, 3) -> (B, embedding_size)``, five
    Linear + BatchNorm + ReLU layers (64, 64, 64, 128, 1024), a max over the
    points, and ``fc``. The reference builds two STNs here that its
    forward never applies; the JAX module, and so this one, has none."""

    def __init__(self, embedding_size: int):
        super().__init__()
        self.names = ("mlp1_0", "mlp1_1", "mlp2_0", "mlp2_1", "mlp2_2")
        width = 3
        for name, f in zip(self.names, (64, 64, 64, 128, 1024)):
            setattr(self, name, nn.Linear(width, f))
            setattr(self, f"{name}_bn", BatchNorm(f))
            width = f
        self.fc = nn.Linear(1024, embedding_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for name in self.names:
            h = _dense_bn_relu(self, name, h)
        return self.fc(h.amax(dim=1))


class PointNetAutoencoder(nn.Module):
    """``(B, N, 3) -> (patches (B, output_num_points, 3), code (B, E))``:
    the encoder, the code L2-normalised when ``normalize``, the decoder."""

    def __init__(self, embedding_size: int, output_num_points: int = 1024, normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        self.encoder = PointNetEncoder(embedding_size)
        self.decoder = PointNetDecoder(embedding_size, output_num_points)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encoder(x)
        if self.normalize:
            z = l2_normalize(z, dim=-1)
        return self.decoder(z), z
