"""Reconstruction losses: chamfer and EMD on full clouds and patch stacks.

Port of ``patchaugnet_tpu/losses/recon.py``, the counterparts of the
reference's ``losses/pointnetvlad_loss.py``:
  - :func:`chamfer_loss`        (:189-202)  ChamferDistanceL1 on clouds
  - :func:`emd_loss`            (:205-221)  auction EMD, eps=0.02 iters=1024
  - :func:`point_pair_loss`     (:224-239)
  - :func:`patch_chamfer_loss`  (:242-247)
  - :func:`patch_emd_loss`      (:250-256)

The patch variants take an optional validity mask: the reference stacks
patches only from "related clouds"; the model emits patches for every
cloud and the mask reproduces the related-clouds-only mean.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import auction_emd, chamfer_sqdists

_EPS = 1e-12


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``x`` over all elements, restricted to ``mask`` (broadcast
    over trailing axes)."""
    if mask is None:
        return x.mean()
    while mask.dim() < x.dim():
        mask = mask[..., None]
    mask = mask.expand(x.shape).to(x.dtype)
    return (x * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def chamfer_l1_masked(
    xyz1: torch.Tensor, xyz2: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """ChamferDistanceL1 reduction with an optional leading-dims mask."""
    d1, d2 = chamfer_sqdists(xyz1, xyz2)
    return (
        _masked_mean(torch.sqrt(d1 + _EPS), mask) + _masked_mean(torch.sqrt(d2 + _EPS), mask)
    ) / 2.0


def chamfer_loss(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """L1 chamfer between batched clouds ``(B, N, 3)``."""
    return chamfer_l1_masked(pc1, pc2, None)


def emd_loss(
    pc1: torch.Tensor, pc2: torch.Tensor, eps: float = 0.02, iters: int = 1024,
    unass_floor: int = 0, eps_schedule=None,
) -> torch.Tensor:
    """Mean over clouds of the mean per-point euclidean EMD distance
    (pointnetvlad_loss.py:218-221).

    The auction runs up to ``iters`` sequential rounds, each with a host
    read; PERF.md has its cost on the card. ``unass_floor`` and
    ``eps_schedule`` are the opt-in convergence knobs of
    :func:`~patchaugnet_tpu_torch.ops.emd.auction_emd`."""
    dist, _ = auction_emd(pc1, pc2, eps, iters, None, unass_floor, eps_schedule)
    return torch.sqrt(dist + _EPS).mean(dim=1).mean()


def point_pair_loss(pc1: torch.Tensor, pc2: torch.Tensor) -> torch.Tensor:
    """Mean pointwise euclidean distance (pointnetvlad_loss.py:224-239)."""
    return torch.sqrt(((pc1 - pc2) ** 2).sum(dim=-1) + _EPS).mean()


def patch_chamfer_loss(
    origin_patches: torch.Tensor,
    recon_patches: torch.Tensor,
    cloud_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """L1 chamfer over stacked patches.

    Args:
      origin_patches / recon_patches: ``(B, M, k, 3)``.
      cloud_mask: optional ``(B,)`` bool, which clouds participate.
    """
    return chamfer_l1_masked(origin_patches, recon_patches, cloud_mask)


def patch_emd_loss(
    origin_patches: torch.Tensor,
    recon_patches: torch.Tensor,
    cloud_mask: Optional[torch.Tensor] = None,
    eps: float = 0.02,
    iters: int = 1024,
    unass_floor: int = 0,
    eps_schedule=None,
) -> torch.Tensor:
    """Auction EMD over stacked patches (pointnetvlad_loss.py:250-256)."""
    b, m, k, _ = origin_patches.shape
    dist, _ = auction_emd(
        origin_patches.reshape(b * m, k, 3), recon_patches.reshape(b * m, k, 3),
        eps, iters, None, unass_floor, eps_schedule,
    )
    per_patch = torch.sqrt(dist + _EPS).mean(dim=1).reshape(b, m)
    return _masked_mean(per_patch, cloud_mask)
