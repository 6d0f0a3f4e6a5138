"""Chamfer distances.

Port of ``patchaugnet_tpu/ops/chamfer.py``: bidirectional nearest-neighbour
distance from one pairwise matrix, the minimum per row and per column;
autograd takes the place of the reference's hand-written CUDA backward.

Reductions mirror the reference modules:
  - ``ChamferDistanceL2``       -> :func:`chamfer_l2`  (mean d1 + mean d2)
  - ``ChamferDistanceL2_split`` -> :func:`chamfer_l2_split`
  - ``ChamferDistanceL1``       -> :func:`chamfer_l1`  ((mean sqrt(d1) + mean sqrt(d2)) / 2)

``torch.amin`` shares the gradient evenly among tied minima, as the JAX
reduction does (``torch.min(dim)`` would give it to one index).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .pairwise import pairwise_sqdist

# keeps sqrt's gradient finite at coincident points
_EPS = 1e-12


def chamfer_sqdists(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point squared NN distances, both directions.

    Args:
      xyz1: ``(..., n, 3)``; xyz2: ``(..., m, 3)``.
    Returns: ``(dist1 (..., n), dist2 (..., m))``.
    """
    d = pairwise_sqdist(xyz1, xyz2)
    return torch.amin(d, dim=-1), torch.amin(d, dim=-2)


def chamfer_l2(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    d1, d2 = chamfer_sqdists(xyz1, xyz2)
    return d1.mean() + d2.mean()


def chamfer_l2_split(xyz1: torch.Tensor, xyz2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d1, d2 = chamfer_sqdists(xyz1, xyz2)
    return d1.mean(), d2.mean()


def chamfer_l1(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    d1, d2 = chamfer_sqdists(xyz1, xyz2)
    return (torch.sqrt(d1 + _EPS).mean() + torch.sqrt(d2 + _EPS).mean()) / 2.0
