"""Peaks of the card and the least time of a kernel call.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, at the 700 W limit).
A bound is the larger of the bytes the call must move (each input read
once, each output written once) over the memory bandwidth and the
operations it must do over the f32 rate (the kernels compute in f32, off
the tensor cores):

- K1, farthest point sampling of m of n points: the clouds read, the
  picks written; ten operations per point and step (three differences,
  three products, two sums, a minimum, a compare), m - 1 steps;
- K2, the k nearest of n candidates to m queries: candidates and queries
  read, k (index, squared distance) pairs written; ten operations per
  pair.
"""
from __future__ import annotations

from typing import Tuple

PEAKS = {
    "float32": 67e12,      # FLOP/s outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, nops: float) -> Tuple[float, str]:
    """(least seconds, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAKS["float32"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fps_bound_s(b: int, n: int, m: int) -> float:
    return bound_s(b * n * 12 + b * m * 4, b * max(m - 1, 0) * n * 10)[0]


def knn_bound_s(b: int, n: int, m: int, k: int) -> float:
    return bound_s(b * (n + m) * 12 + b * m * k * 8, b * m * n * 10)[0]
