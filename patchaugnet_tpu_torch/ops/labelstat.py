"""Label-statistics and feature-distribution ops.

Port of ``patchaugnet_tpu/ops/labelstat.py`` (reference
``libs/pointops``: ``labelstat_ballrange``, ``labelstat_idx``,
``labelstat_and_ballquery``, ``featuredistribute``, ``featuregather``).
Plain torch ops: the JAX package forms them with XLA, no kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .grouping import gather, group
from .knn import ball_query
from .pairwise import pairwise_sqdist


def labelstat_ballrange(
    radius: float, xyz: torch.Tensor, new_xyz: torch.Tensor, label_stat: torch.Tensor
) -> torch.Tensor:
    """Sum the per-class counts of every point within ``radius`` of each
    centre (membership as :func:`ops.ball_query` decides it).

    Args:
      xyz: ``(b, n, 3)``; new_xyz: ``(b, m, 3)``;
      label_stat: ``(b, n, nclass)`` integer counts.
    Returns: ``(b, m, nclass)`` int32.

    The JAX version is an int32 einsum; CUDA torch has no integer matrix
    product, so this is a float64 product of the 0/1 membership and the
    counts, exact while every sum stays below 2**53 and unaffected by
    TF32, then cast to int32.
    """
    d = pairwise_sqdist(new_xyz, xyz)                      # (b, m, n)
    in_ball = (d < torch.full((), radius * radius, dtype=d.dtype, device=d.device)).to(torch.float64)
    return torch.bmm(in_ball, label_stat.to(torch.float64)).to(torch.int32)


def labelstat_idx(label_stat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sum the class counts over an explicit ``(b, m, nsample)`` index
    table: ``(b, m, nclass)`` int32."""
    return group(label_stat.to(torch.int32), idx).sum(dim=2, dtype=torch.int32)


def labelstat_and_ballquery(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor, label_stat: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused variant: ``(new_label_stat, idx)``. As the CUDA kernel
    (``labelstat_cuda_kernel.cu:5-50``), the counts sum over ALL in-radius
    points, not only the ``nsample`` kept in ``idx``."""
    return labelstat_ballrange(radius, xyz, new_xyz, label_stat), ball_query(radius, nsample, xyz, new_xyz)


def featuredistribute(max_xyz: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Index of the nearest ``max_xyz`` point for each ``xyz`` point, the
    lowest index among tied ones (``argmin``).

    Args: max_xyz ``(b, n, 3)``, xyz ``(b, m, 3)``.
    Returns: ``(b, m)`` int32.
    """
    return torch.argmin(pairwise_sqdist(xyz, max_xyz), dim=-1).to(torch.int32)


def featuregather(max_feature: torch.Tensor, distribute_idx: torch.Tensor) -> torch.Tensor:
    """Gather features by distribute index: ``(b, n, c), (b, m) -> (b, m, c)``;
    its backward is the gather's scatter-add, the CUDA kernel's
    hand-written backward (``featuredistribute_cuda_kernel.cu``)."""
    return gather(max_feature, distribute_idx)
