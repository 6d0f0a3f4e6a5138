"""MinkLoc-style point-cloud augmentations (numpy, host-side).

Port of ``patchaugnet_tpu/data/augment.py``, the tensor augmentations of
the reference's ``utils/loading_pointclouds.py:320-449``, copied
operation for operation: on the same ``np.random.RandomState`` (or, with
``rng=None``, on the global ``np.random`` stream in the same state) each
function draws the same numbers and returns the same bits.
  - :func:`jitter_points`        <- JitterPoints (per-point gaussian,
        optional per-cloud probability mask)
  - :func:`remove_random_points` <- RemoveRandomPoints (zero a random
        ratio of points — zeros, not removal, so shapes stay static:
        exactly the reference's trick)
  - :func:`remove_random_block`  <- RemoveRandomBlock (RandomErasing
        cuboid on the xy plane)
  - :func:`random_translation`   <- RandomTranslation
  - :func:`random_rotation`      <- RandomRotation (axis-angle exp map
        with secondary wobble; ``scipy.linalg.expm``)
  - :func:`random_flip`          <- RandomFlip
  - :func:`train_transform` / :func:`train_set_transform` — the composed
        pipelines used by the MinkLoc trainer.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np


def _rng(rng):
    return rng if rng is not None else np.random


def jitter_points(e: np.ndarray, sigma: float = 0.01, clip: Optional[float] = None,
                  p: float = 1.0, rng=None) -> np.ndarray:
    if not (0 < p <= 1.0 and sigma > 0):
        raise ValueError(f"jitter_points needs 0 < p <= 1 and sigma > 0, got p={p}, sigma={sigma}")
    rng = _rng(rng)
    e = e.copy()
    mask = np.ones(e.shape[0], bool) if p >= 1.0 else rng.rand(e.shape[0]) < p
    jit = sigma * rng.randn(*e[mask].shape)
    if clip is not None:
        jit = np.clip(jit, -clip, clip)
    e[mask] = e[mask] + jit
    return e


def remove_random_points(e: np.ndarray, r, rng=None) -> np.ndarray:
    rng = _rng(rng)
    if isinstance(r, (list, tuple)):
        r = rng.uniform(float(r[0]), float(r[1]))
    e = e.copy()
    n = len(e)
    sel = rng.choice(n, size=int(n * float(r)), replace=False)
    e[sel] = 0.0
    return e


def random_translation(e: np.ndarray, max_delta: float = 0.05, rng=None) -> np.ndarray:
    return e + max_delta * _rng(rng).randn(1, 3)


def remove_random_block(
    coords: np.ndarray, p: float = 0.5,
    scale: Tuple[float, float] = (0.02, 0.33),
    ratio: Tuple[float, float] = (0.3, 3.3),
    rng=None,
) -> np.ndarray:
    rng = _rng(rng)
    if rng.rand() >= p:
        return coords
    coords = coords.copy()
    flat = coords.reshape(-1, 3)
    mins, maxs = flat.min(0), flat.max(0)
    span = maxs - mins
    area = span[0] * span[1]
    erase = rng.uniform(*scale) * area
    aspect = rng.uniform(*ratio)
    h = math.sqrt(max(erase * aspect, 0))
    w = math.sqrt(max(erase / aspect, 0))
    x = mins[0] + rng.uniform() * max(span[0] - w, 0)
    y = mins[1] + rng.uniform() * max(span[1] - h, 0)
    mask = (
        (x < coords[..., 0]) & (coords[..., 0] < x + w)
        & (y < coords[..., 1]) & (coords[..., 1] < y + h)
    )
    coords[mask] = 0.0
    return coords


def _exp_m(axis: np.ndarray, theta: float) -> np.ndarray:
    from scipy.linalg import expm   # imported here: scipy.linalg takes a second to import

    axis = axis / np.linalg.norm(axis)
    return expm(np.cross(np.eye(3), axis * theta)).astype(np.float32)


def random_rotation(
    coords: np.ndarray,
    axis: Optional[np.ndarray] = None,
    max_theta: float = 180.0,
    max_theta2: Optional[float] = 15.0,
    rng=None,
) -> np.ndarray:
    rng = _rng(rng)
    if axis is None:
        axis = rng.rand(3) - 0.5
    r = _exp_m(np.asarray(axis, float), (np.pi * max_theta / 180) * 2 * (rng.rand() - 0.5))
    if max_theta2 is None or max_theta2 == 0:
        return coords @ r
    r2 = _exp_m(rng.rand(3) - 0.5, (np.pi * max_theta2 / 180) * 2 * (rng.rand() - 0.5))
    return coords @ r @ r2


def random_flip(coords: np.ndarray, p: Sequence[float], rng=None) -> np.ndarray:
    if not (len(p) == 3 and 0 < sum(p) <= 1):
        raise ValueError(f"random_flip needs three probabilities summing to (0, 1], got {p}")
    rng = _rng(rng)
    coords = coords.copy()
    cs = np.cumsum(p)
    r = rng.rand()
    for axis in range(3):
        if r <= cs[axis]:
            coords[..., axis] = -coords[..., axis]
            break
    return coords


def train_transform(e: np.ndarray, rng=None) -> np.ndarray:
    """MinkLoc per-cloud TrainTransform (loading_pointclouds.py:404-409)."""
    e = jitter_points(e, sigma=0.001, clip=0.002, rng=rng)
    e = remove_random_points(e, r=(0.0, 0.1), rng=rng)
    e = random_translation(e, max_delta=0.01, rng=rng)
    e = remove_random_block(e, p=0.4, rng=rng)
    return e


def train_set_transform(e: np.ndarray, rng=None) -> np.ndarray:
    """MinkLoc batch-level TrainSetTransform (loading_pointclouds.py:445-449)."""
    e = random_rotation(e, axis=np.array([0.0, 0.0, 1.0]), max_theta=5, max_theta2=None, rng=rng)
    e = random_flip(e, [0.25, 0.25, 0.0], rng=rng)
    return e
