"""Geometry helpers: bbox IoU, grid overlap ratio, correspondences,
rotations, pose errors, voxel downsampling and ICP (numpy on the host).

Port of ``patchaugnet_tpu/utils/geometry.py`` (the numeric helpers of the
reference's ``utils/util.py`` and ``utils/train_util.py``):
  - :func:`iou_2d` / :func:`iou_3d` (:85-125)
  - :func:`compute_overlap_ratio` (:127-203) — vectorised occupancy grids
  - :func:`get_overlap_indices` (:226-253) — bidirectional
    nearest-neighbour correspondences within ``max_dist``
  - rotation and pose-error helpers (:256-296)
  - :func:`nn_dist`, :func:`nn_angle` (train_util.py:223-277)
  - :func:`voxel_downsample`, :func:`icp_point_to_point`
    (Minkloc3D_V2/misc/point_clouds.py:31-60)

The nearest-neighbour searches run on ``scipy.spatial.cKDTree`` where the
JAX package uses sklearn's ``KDTree``: both return exact float64
distances, so the ``<= max_dist`` borders fall on the same bits, but
between neighbours at exactly the same distance the two trees may pick
different ones. :func:`nn_angle` runs the port's ``nn.nn_angle`` (its kNN
is one K2 launch) on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch


def iou_2d(box1: Sequence[float], box2: Sequence[float]) -> float:
    """IoU of axis-aligned 2D boxes ``[x1, y1, x2, y2]``."""
    area1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    area2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    x1, y1 = max(box1[0], box2[0]), max(box1[1], box2[1])
    x2, y2 = min(box1[2], box2[2]), min(box1[3], box2[3])
    if x1 >= x2 or y1 >= y2:
        return 0.0
    inter = (x2 - x1) * (y2 - y1)
    return inter / (area1 + area2 - inter)


def iou_3d(box1: Sequence[float], box2: Sequence[float]) -> float:
    """IoU of axis-aligned 3D boxes ``[x1, y1, z1, x2, y2, z2]``."""
    v1 = (box1[3] - box1[0]) * (box1[4] - box1[1]) * (box1[5] - box1[2])
    v2 = (box2[3] - box2[0]) * (box2[4] - box2[1]) * (box2[5] - box2[2])
    lo = [max(box1[i], box2[i]) for i in range(3)]
    hi = [min(box1[i + 3], box2[i + 3]) for i in range(3)]
    if any(lo[i] >= hi[i] for i in range(3)):
        return 0.0
    inter = (hi[0] - lo[0]) * (hi[1] - lo[1]) * (hi[2] - lo[2])
    return inter / (v1 + v2 - inter)


def _grid_occupancy(points: np.ndarray, mins: np.ndarray, shape, resolution: float):
    ids = ((points - mins) / resolution).astype(np.int64)
    flat = np.ravel_multi_index(tuple(ids.T), shape, mode="clip")
    occ = np.zeros(int(np.prod(shape)), bool)
    occ[flat] = True
    return occ


def compute_overlap_ratio(
    points1: np.ndarray,
    points2: np.ndarray,
    use_2d: bool = True,
    use_grid: bool = True,
    grid_resolution: float = 1.0,
) -> float:
    """Grid-based overlap IoU of two clouds (util.py:127-203), with the
    per-point / per-cell loops replaced by vectorised occupancy masks."""
    points1 = np.asarray(points1).reshape(-1, 3)
    points2 = np.asarray(points2).reshape(-1, 3)
    d = 2 if use_2d else 3
    p1, p2 = points1[:, :d], points2[:, :d]
    min1, max1 = p1.min(0), p1.max(0)
    min2, max2 = p2.min(0), p2.max(0)
    if use_2d:
        bbox_iou = iou_2d([*min1, *max1], [*min2, *max2])
    else:
        bbox_iou = iou_3d([*min1, *max1], [*min2, *max2])
    if bbox_iou <= 0.0 or not use_grid:
        return bbox_iou
    mins = np.minimum(min1, min2)
    maxs = np.maximum(max1, max2)
    shape = tuple((((maxs - mins) / grid_resolution).astype(np.int64) + 1).tolist())
    occ1 = _grid_occupancy(p1, mins, shape, grid_resolution)
    occ2 = _grid_occupancy(p2, mins, shape, grid_resolution)
    inter = np.logical_and(occ1, occ2).sum()
    union = occ1.sum() + occ2.sum() - inter
    return float(inter) / max(float(union), 1.0)


def get_overlap_indices(
    pc1: np.ndarray, pc2: np.ndarray, max_dist: float = 0.2
) -> Tuple[Set[int], Set[int]]:
    """Bidirectional NN correspondences within ``max_dist``
    (util.py:226-253), batched through ``cKDTree`` queries."""
    from scipy.spatial import cKDTree   # imported here: scipy.spatial takes a second

    pc1, pc2 = np.asarray(pc1), np.asarray(pc2)
    tree1, tree2 = cKDTree(pc1), cKDTree(pc2)
    indices1: Set[int] = set()
    indices2: Set[int] = set()
    d21, i21 = tree2.query(pc1)
    hit = d21 <= max_dist
    indices1 |= set(np.where(hit)[0].tolist())
    indices2 |= set(i21[hit].tolist())
    d12, i12 = tree1.query(pc2)
    hit = d12 <= max_dist
    indices2 |= set(np.where(hit)[0].tolist())
    indices1 |= set(i12[hit].tolist())
    return indices1, indices2


def rotation_matrix_z(angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def apply_transform(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to ``(N, 3)`` points."""
    r, t = transform[:3, :3], transform[:3, 3]
    return points @ r.T + t


def relative_rotation_error(r1: np.ndarray, r2: np.ndarray) -> float:
    """RRE in degrees (cmp_stat.py comparison metric)."""
    cos = (np.trace(r1.T @ r2) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def relative_translation_error(t1: np.ndarray, t2: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(t1) - np.asarray(t2)))


def nn_dist(c: np.ndarray) -> np.ndarray:
    """All-pairs euclidean distances: ``(m, 3)`` or ``(b, m, 3)``
    (utils/train_util.py:223-239)."""
    c = np.asarray(c)
    if c.ndim == 2:
        d = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    else:
        d = ((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)
    return np.sqrt(d)


def nn_angle(c: np.ndarray, k: int = 3, device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Cosine of angles between each point's edge to every other point
    and its k nearest-neighbour edges (utils/train_util.py:242-277 —
    the KNN_CUDA consumer; here the kNN is the port's own op).

    Args: c ``(m, 3)`` or ``(b, m, 3)``. Returns ``(b, k, m, m)`` float32.
    Host-side wrapper over ``nn.nn_angle`` (one implementation of the
    angle math), which runs on ``device``: on the card its kNN is one K2
    launch per call.
    """
    from ..nn.extras import nn_angle as _nn_angle

    c = np.asarray(c, np.float32)
    if c.ndim == 2:
        c = c[None]
    with torch.no_grad():
        return _nn_angle(torch.from_numpy(c).to(device), k).cpu().numpy()


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average points within occupied voxels (open3d
    voxel_down_sample analogue used by the ICP path,
    Minkloc3D_V2/misc/point_clouds.py:36-44)."""
    pts = np.asarray(points, np.float64)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv, pts)
    return (sums / counts[:, None]).astype(points.dtype)


def icp_point_to_point(
    source: np.ndarray,
    target: np.ndarray,
    init_transform: Optional[np.ndarray] = None,
    max_iterations: int = 200,
    inlier_dist_threshold: float = 1.2,
    tol: float = 1e-7,
) -> Tuple[np.ndarray, float]:
    """Point-to-point ICP (open3d registration_icp analogue,
    Minkloc3D_V2/misc/point_clouds.py:31-60; no open3d here).

    Returns ``(4x4 transform, inlier RMSE)``.
    """
    from scipy.spatial import cKDTree   # imported here: scipy.spatial takes a second

    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    T = np.eye(4) if init_transform is None else np.asarray(init_transform, np.float64)
    tree = cKDTree(tgt)
    prev_err = np.inf
    for _ in range(max_iterations):
        cur = src @ T[:3, :3].T + T[:3, 3]
        dist, idx = tree.query(cur)
        mask = dist <= inlier_dist_threshold
        if mask.sum() < 3:
            break
        p = cur[mask]
        q = tgt[idx[mask]]
        err = float(np.sqrt((dist[mask] ** 2).mean()))
        if abs(prev_err - err) < tol:
            prev_err = err
            break
        prev_err = err
        mp, mq = p.mean(0), q.mean(0)
        h = (p - mp).T @ (q - mq)
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        t = mq - r @ mp
        delta = np.eye(4)
        delta[:3, :3] = r
        delta[:3, 3] = t
        T = delta @ T
    return T, prev_err
