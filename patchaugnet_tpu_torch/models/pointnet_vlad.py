"""PointNetVLAD (channels-last).

Port of ``patchaugnet_tpu/models/pointnet_vlad.py`` (reference
``pointnet_vlad/PointNetVlad.py``): an STN input transform, an optional
STN feature transform, a stack of Linear + BatchNorm layers to 1024-d
per-point features, and the NetVLAD loupe head. The reference builds it as
``PointNetVlad(global_feat=True, feature_transform=True, max_pool=False,
output_dim=256, num_points=4096)``; ``num_points`` sizes nothing (the
JAX modules take and ignore it), so the port takes none. A compute dtype
(``COMPUTE_DTYPE``, ``compute_dtype``) runs the conv stack and the VLAD
core's products at it; the two STNs and their products stay f32, and the
descriptor comes back f32. The point-axis sharding (``shard_axis``, ROADMAP
A11) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import STN3D, BatchNorm, NetVLADLoupe
from ..nn.core import Dense

# the conv stack: (name, output width, ReLU after its BatchNorm)
_CONVS = (("conv1", 64, True), ("conv2", 64, True), ("conv3", 64, True), ("conv4", 128, True),
          ("conv5", 1024, False))


class PointNetFeat(nn.Module):
    """``(B, N, 3) -> (B, N, 1024)`` per-point features, or ``(B, 1024)``
    with ``max_pool``.

    ``x @ stn(x)`` (an STN3D without BatchNorm), conv1 and conv2, then with
    ``feature_transform`` ``x @ feature_trans(x)`` (STN3D at k=64, without
    BatchNorm), conv3 to conv5; each conv a Linear and a BatchNorm
    (``conv{i}_bn``), with a ReLU after all but conv5, at the compute
    ``dtype``. The products with the transforms are f32.
    """

    def __init__(self, feature_transform: bool = True, max_pool: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.max_pool = max_pool
        self.stn = STN3D(k=3, use_bn=False)
        width = 3
        for name, f, _ in _CONVS:
            setattr(self, name, Dense(width, f, dtype=dtype))
            setattr(self, f"{name}_bn", BatchNorm(f))
            width = f
        self.feature_trans = STN3D(k=64, use_bn=False) if feature_transform else None

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group``: the process group over which the N axis of ``x`` is
        split (point-axis sharding, eval only; the transforms' max-pools
        run over it). Not with ``max_pool``."""
        if group is not None and self.max_pool:
            raise ValueError("a point-sharded PointNetFeat returns per-point features (max_pool=False)")
        x = torch.bmm(x, self.stn(x, group))
        for name, _, relu in _CONVS:
            bn, h = getattr(self, f"{name}_bn"), getattr(self, name)(x)
            x = bn.relu(h) if relu else bn(h)
            if name == "conv2" and self.feature_trans is not None:
                x = torch.bmm(x.to(torch.float32), self.feature_trans(x, group))
        return x.amax(dim=1) if self.max_pool else x


class PointNetVLAD(nn.Module):
    """``(B, N, 3) -> (B, output_dim)`` global descriptor, a bare tensor as
    the JAX model returns it: ``point_net`` (PointNetFeat) and ``net_vlad``
    (NetVLADLoupe over 1024-d features, 64 clusters, gating), at the
    compute ``dtype`` (None: f32); the descriptor is f32."""

    def __init__(self, output_dim: int = 256, feature_transform: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.point_net = PointNetFeat(feature_transform, max_pool=False, dtype=compute_dtype)
        self.net_vlad = NetVLADLoupe(feature_size=1024, cluster_size=64, output_dim=output_dim, gating=True,
                                     dtype=compute_dtype)

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``group``: the process group over which the N axis of ``x`` is
        split (``parallel.sharded_pointnetvlad_descriptor``, eval only)."""
        if x.dim() == 4:                                   # accept (B, 1, N, 3)
            x = x.squeeze(1)
        return self.net_vlad(self.point_net(x, group), group).to(torch.float32)
