"""Pairwise squared-distance primitives.

Port of ``patchaugnet_tpu/ops/pairwise.py``: :func:`pairwise_sqdist` and
:func:`self_sqdist`. Two formulations,
dispatched on the coordinate width:

- ``d <= 4`` (xyz space): direct per-coordinate differences, starting
  from zeros and adding ``diff * diff`` for coordinates 0, 1, 2, ... in
  order, then the clamp at 0. Every index the point ops return (kNN,
  3-NN, FPS ties) rests on these exact f32 bits, and the CUDA kernels
  form their distances in the same order with no fused multiply-add.
  Each torch op here is its own elementwise kernel, so nothing fuses.
- wider ``d`` (feature space): the ``||x||^2 + ||y||^2 - 2 x.y^T``
  expansion, one matrix product.
"""
from __future__ import annotations

import torch

# widest coordinate dim that uses the direct-difference formulation
_DIRECT_MAX_D = 4


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between two point sets.

    Args:
      x: ``(..., n, d)`` query points.
      y: ``(..., m, d)`` reference points.

    Returns:
      ``(..., n, m)`` where ``out[..., i, j] = ||x_i - y_j||^2`` (clamped at 0).
    """
    if x.shape[-1] != y.shape[-1]:
        raise ValueError(
            f"pairwise_sqdist: coordinate widths differ, x {tuple(x.shape)} "
            f"vs y {tuple(y.shape)}"
        )
    if x.shape[-1] <= _DIRECT_MAX_D:
        shape = torch.broadcast_shapes(
            x.shape[:-2] + (x.shape[-2], 1), y.shape[:-2] + (1, y.shape[-2])
        )
        d = torch.zeros(shape, dtype=torch.promote_types(x.dtype, y.dtype), device=x.device)
        for c in range(x.shape[-1]):
            diff = x[..., :, None, c] - y[..., None, :, c]
            d = d + diff * diff
        return d.clamp_min(0.0)
    x2 = (x * x).sum(-1, keepdim=True)                     # (..., n, 1)
    y2 = (y * y).sum(-1, keepdim=True)                     # (..., m, 1)
    xy = torch.einsum("...nd,...md->...nm", x, y)
    d = x2 + y2.transpose(-1, -2) - 2.0 * xy
    return d.clamp_min(0.0)


def self_sqdist(x: torch.Tensor) -> torch.Tensor:
    """``pairwise_sqdist(x, x)`` with exact zeros on the diagonal."""
    d = pairwise_sqdist(x, x)
    n = d.shape[-1]
    return d.masked_fill(torch.eye(n, dtype=torch.bool, device=d.device), 0.0)
