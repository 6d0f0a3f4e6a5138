"""PointNet blocks.

Port of ``PointNetDecoder`` of ``patchaugnet_tpu/nn/pointnet.py``
(reference ``pointnet_autoencoder.py:85-111``), the patch decoder of
PatchAugNet's a2a reconstruction loss. Attribute names follow the JAX
variable tree (``fc1``, ``bn1``, ...), so ``compat.load_jax_variables``
maps it as it stands. (STN3D and the PointNet encoder come with
PointNetVLAD.)
"""
from __future__ import annotations

import torch
from torch import nn

from .core import BatchNorm


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
        h = torch.relu(self.bn1(self.fc1(z)))
        h = torch.relu(self.bn2(self.fc2(h)))
        h = torch.tanh(self.fc3(h))
        return h.reshape(-1, self.num_points, self.output_channels)
