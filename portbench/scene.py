"""LiDAR-submap-like clouds from a seed: the benchmark's traffic source.

A copy of ``patchaugnet_tpu_torch/data/pointclouds.py::synthetic_scene_clouds``
(ground plane, six building facades, clutter, each cloud centred and
scaled to the unit sphere), drawn for a whole batch at once from a
``numpy.random.Generator``, so a pool of thousands of clouds takes well
under a second. The same seed gives the same clouds.
"""
from __future__ import annotations

import numpy as np

GROUND_SHARE = 0.45
FACADE_SHARE = 0.45
FACADES = 6


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use (``stream``) of a run's seed; any whole seed."""
    return np.random.default_rng([seed % 2**64, stream])


def scene_clouds(rng: np.random.Generator, batch: int, num_points: int, extent_m: float = 25.0) -> np.ndarray:
    """``(batch, num_points, 3)`` float32 clouds on the unit sphere."""
    half = extent_m / 2
    n_g = int(num_points * GROUND_SHARE)
    n_f = int(num_points * FACADE_SHARE) // FACADES
    rem = num_points - n_g - FACADES * n_f
    ground = np.stack([rng.random((batch, n_g)) * extent_m - half,
                       rng.random((batch, n_g)) * extent_m - half,
                       rng.standard_normal((batch, n_g)) * 0.05], axis=-1)
    centre = rng.random((batch, FACADES, 1, 2)) * (extent_m * 0.8) - half * 0.8
    width = 4 + rng.random((batch, FACADES, 1)) * 8
    height = 3 + rng.random((batch, FACADES, 1)) * 8
    theta = rng.random((batch, FACADES, 1)) * np.pi
    u = rng.random((batch, FACADES, n_f)) * width - width / 2
    z = rng.random((batch, FACADES, n_f)) * height
    facades = np.stack([centre[..., 0] + u * np.cos(theta), centre[..., 1] + u * np.sin(theta), z], axis=-1)
    facades = facades + rng.standard_normal(facades.shape) * 0.02
    clutter = np.stack([rng.random((batch, rem)) * extent_m - half,
                        rng.random((batch, rem)) * extent_m - half,
                        rng.random((batch, rem)) * 4], axis=-1)
    pc = np.concatenate([ground, facades.reshape(batch, FACADES * n_f, 3), clutter], axis=1).astype(np.float32)
    pc = pc - pc.mean(axis=1, keepdims=True)
    scale = np.sqrt((pc ** 2).sum(axis=-1)).max(axis=1)
    return (pc / scale[:, None, None]).astype(np.float32)
