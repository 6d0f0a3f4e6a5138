"""Point-cloud IO, normalisation and augmentation (host-side numpy).

Port of ``patchaugnet_tpu/data/pointclouds.py`` (the reference's
``utils/loading_pointclouds.py``):
  - :func:`load_pc_file` / :func:`load_pc_files` (:14-48)
  - :func:`normalize_point_cloud(s)` (:51-75) with scale/trans metadata
  - :func:`abnormalize_point_cloud(s)` (:78-99); the batched torch
    version becomes :func:`abnormalize_batch` (one einsum on the
    tensors' device)
  - :func:`rotate_point_cloud` (:102-128) — z-axis +-90 deg, updating the
    norm-meta scale by the inverse rotation
  - :func:`rotate_point_cloud_deg` (:131-161), :func:`jitter_point_cloud`
    (:163-174)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def load_pc_file(
    filepath: str,
    input_dim: int = 3,
    num_points: int = 4096,
    use_np_load: bool = False,
    dtype=np.float64,
) -> np.ndarray:
    """Read one submap: raw float64/float32 ``.bin`` or ``.npy``."""
    if use_np_load:
        return np.load(filepath).reshape([-1, 3])
    pc = np.fromfile(filepath, dtype=dtype)
    if input_dim == 3:
        return pc.reshape([-1, 3])
    if pc.shape[0] != num_points * 13:
        print(f"Error in pointcloud shape {pc.shape} {filepath}")
        return np.zeros([num_points, 13])
    pc = pc.reshape(-1, 13)
    rng = pc.max(axis=0) - pc.min(axis=0)
    pc[:, 3:12] = ((pc - pc.min(axis=0)) / np.where(rng == 0, 1, rng))[:, 3:12]
    pc[np.isnan(pc)] = 0.0
    pc[np.isinf(pc)] = 1.0
    return pc


def load_pc_files(
    filenames: Sequence[str],
    dataset_folder: str = "",
    input_dim: int = 3,
    use_np_load: bool = False,
    dtype=np.float64,
) -> List[np.ndarray]:
    pcs = []
    for name in filenames:
        path = os.path.join(dataset_folder, name)
        if os.path.exists(path):
            pcs.append(load_pc_file(path, input_dim, use_np_load=use_np_load, dtype=dtype))
    return pcs


def normalize_point_cloud(
    pc: np.ndarray, return_norm_meta: bool = False, zoom: bool = True
):
    """Centre and scale to the unit sphere; meta allows exact inversion."""
    pc = pc.reshape([-1, 3])
    centroid = pc.mean(axis=0)
    pc = pc - centroid
    m = 1.0
    if zoom:
        m = float(np.max(np.sqrt(np.sum(pc ** 2, axis=1))))
        pc = pc / m
    if return_norm_meta:
        return pc, {"scale": m, "trans": centroid}
    return pc


def normalize_point_clouds(pcs, return_norm_meta: bool = False, zoom: bool = True):
    metas = []
    out = []
    for pc in pcs:
        pc, meta = normalize_point_cloud(pc, True, zoom)
        out.append(pc)
        metas.append(meta)
    if return_norm_meta:
        return out, metas
    return out


def abnormalize_point_cloud(pc: np.ndarray, norm_meta: Dict) -> np.ndarray:
    """Invert normalisation (scale may be scalar or a 3x3 rotation-scale)."""
    pc = np.dot(pc.reshape((-1, 3)), np.atleast_2d(norm_meta["scale"]))
    if np.isscalar(norm_meta["scale"]) or np.ndim(norm_meta["scale"]) == 0:
        pc = pc.reshape(-1, 3)
    return pc + norm_meta["trans"]


def abnormalize_batch(pc_batch: torch.Tensor, norm_scales: torch.Tensor,
                      norm_trans: torch.Tensor) -> torch.Tensor:
    """Batched inverse-normalisation: ``(B,N,3)x(B,3,3)+(B,1,3)``.

    Replaces ``abnormalize_point_clouds_pytorch`` (loading_pointclouds.py:92-99)
    with one einsum.
    """
    return torch.einsum("bnd,bde->bne", pc_batch, norm_scales) + norm_trans


def rotate_point_cloud(
    batch: np.ndarray,
    norm_meta: Optional[List[Dict]] = None,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, List[Dict]]:
    """Random z-rotation in [-90 deg, 90 deg] per cloud; the norm-meta
    scale absorbs the inverse rotation so abnormalize() still recovers
    the raw cloud."""
    rng = rng or np.random
    rotated = np.zeros(batch.shape, dtype=np.float32)
    rotated_meta: List[Dict] = []
    for k in range(batch.shape[0]):
        angle = (rng.uniform() * np.pi) - np.pi / 2.0
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        rotated[k] = batch[k].reshape(-1, 3) @ rot
        if norm_meta is not None:
            meta = dict(norm_meta[k])
            meta["scale"] = np.multiply(np.linalg.inv(rot), meta["scale"])
            rotated_meta.append(meta)
    return rotated, rotated_meta


def rotate_point_cloud_deg(
    batch: np.ndarray, deg: int, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    rng = rng or np.random
    scale = {10: 1 / 9.0, 20: 2 / 9.0, 30: 1 / 3.0}
    if deg not in scale:
        raise ValueError(f"deg must be 10/20/30, got {deg}")
    rotated = np.zeros(batch.shape, dtype=np.float32)
    for k in range(batch.shape[0]):
        angle = ((rng.uniform() * np.pi) - np.pi / 2.0) * scale[deg]
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        rotated[k] = batch[k].reshape(-1, 3) @ rot
    return rotated


def jitter_point_cloud(
    batch: np.ndarray,
    sigma: float = 0.005,
    clip: float = 0.05,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    rng = rng or np.random
    assert clip > 0
    noise = np.clip(sigma * rng.randn(*batch.shape), -clip, clip)
    return batch + noise


def synthetic_scene_clouds(
    rng, batch: int, num_points: int, extent_m: float = 25.0
) -> np.ndarray:
    """LiDAR-submap-like surface clouds: ground plane + building
    facades + clutter, unit-sphere normalized like the data pipeline.

    The uniform-cube clouds used elsewhere for synthetic data are
    volumetric — the worst case for voxel merging — while real submaps
    (the reference's Oxford/in-house benchmarks) are surfaces whose
    sparse-pyramid occupancy collapses at stride-2 levels
    (_probe_occupancy.py: levels 1-4 at 0.82/0.53/0.23/0.055 of
    N=4096 vs >=0.9 for uniform). Capacity calibration and the sparse
    benchmarks use this geometry as the realistic proxy.
    """
    out = []
    half = extent_m / 2
    for _ in range(batch):
        pts = []
        n_g = int(num_points * 0.45)
        pts.append(
            np.stack(
                [
                    rng.rand(n_g) * extent_m - half,
                    rng.rand(n_g) * extent_m - half,
                    rng.randn(n_g) * 0.05,
                ],
                axis=-1,
            )
        )
        n_f = int(num_points * 0.45) // 6
        for _f in range(6):
            cx, cy = rng.rand(2) * (extent_m * 0.8) - half * 0.8
            w, h = 4 + rng.rand() * 8, 3 + rng.rand() * 8
            theta = rng.rand() * np.pi
            u = rng.rand(n_f) * w - w / 2
            z = rng.rand(n_f) * h
            pts.append(
                np.stack(
                    [cx + u * np.cos(theta), cy + u * np.sin(theta), z],
                    axis=-1,
                )
                + rng.randn(n_f, 3) * 0.02
            )
        rem = num_points - sum(p.shape[0] for p in pts)
        pts.append(
            np.stack(
                [
                    rng.rand(rem) * extent_m - half,
                    rng.rand(rem) * extent_m - half,
                    rng.rand(rem) * 4,
                ],
                axis=-1,
            )
        )
        pc = np.concatenate(pts, axis=0).astype(np.float32)
        out.append(normalize_point_cloud(pc))
    return np.stack(out)
