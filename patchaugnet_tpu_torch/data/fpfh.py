"""Fast Point Feature Histograms for the rerank pipeline (host, float64).

Port of ``patchaugnet_tpu/data/fpfh.py``, the reference's
``SceneDataSet.get_fpfh`` (datasets/scene_dataset.py:756-780), which
delegates to open3d (``estimate_normals`` + ``compute_fpfh_feature`` with
``KDTreeSearchParamHybrid``). The math is the JAX package's vectorised
numpy, copied operation for operation (so its results are the same bits),
following the published FPFH formulation (R. B. Rusu, N. Blodow,
M. Beetz, "Fast Point Feature Histograms (FPFH) for 3D Registration",
ICRA 2009) in the PCL/open3d conventions:

  - hybrid neighbourhood: all points within ``radius``, capped at the
    ``max_nn`` nearest (query point included, as KD-tree hybrid search
    over the same cloud returns it at distance 0);
  - normals: smallest eigenvector of the neighbourhood covariance;
    orientation is disambiguated deterministically (flipped so the
    +z component — falling back to +y, +x — is nonnegative);
  - pair features for (p_s, p_t) with normals (n_s, n_t) after the
    PCL source/target swap (the point whose normal has the smaller
    angle to the connecting line becomes the source):
        u = n_s,  v = (d x u)/|d x u|,  w = u x v,  d = (p_t - p_s)/|..|
        alpha = v . n_t,  phi = u . d,  theta = atan2(w . n_t, u . n_t)
  - SPFH: per-point 33-bin histogram (11 bins per feature; alpha and
    phi binned over [-1, 1], theta over [-pi, pi]), each neighbour
    contributing ``100 / n_pairs``;
  - FPFH(p) = SPFH(p) + normalised sum over neighbours k of
    ``SPFH(k) / ||p - p_k||^2``, with the weighted sum rescaled per
    11-bin group to total 100.

:func:`compute_fpfh` runs the C++ implementation of the same formulation
(:mod:`.fpfh_native`, built from ``csrc/fpfh.cc``) unless the caller
chooses this numpy route with ``use_native=False`` or
``PCR_FPFH_NATIVE=0``; where the library does not build it raises, where
the JAX package falls back to numpy.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

FPFH_DIM = 33
_NBINS = 11


def _hybrid_neighbors(
    points: np.ndarray, radius: float, max_nn: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """KDTreeSearchParamHybrid equivalent over one cloud.

    Returns ``(idx (N, K), valid (N, K), sqdist (N, K))`` with K =
    ``min(max_nn, N)``: the nearest in-radius points per query, sorted
    ascending by distance (query itself first at distance 0).
    """
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    k = min(max_nn, n)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)       # (N, N)
    if k < n:
        part = np.argpartition(d2, kth=k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.take_along_axis(
            part, np.argsort(pd, axis=1, kind="stable"), axis=1
        )
    else:
        order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    sd = np.take_along_axis(d2, order, axis=1)
    valid = sd <= radius * radius
    return order.astype(np.int64), valid, sd


def estimate_normals(
    points: np.ndarray, radius: float = 0.05, max_nn: int = 30
) -> np.ndarray:
    """Per-point unit normals from neighbourhood covariance
    (open3d ``estimate_normals`` semantics; deterministic sign)."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    idx, valid, _ = _hybrid_neighbors(pts, radius, max_nn)
    nbr = pts[idx]                                                # (N, K, 3)
    w = valid[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(1), 1.0)                               # (N, 1)
    mean = (nbr * w).sum(1) / cnt
    cen = (nbr - mean[:, None, :]) * w
    cov = np.einsum("nki,nkj->nij", cen, cen) / cnt[..., None]
    # smallest-eigenvalue eigenvector of each 3x3 covariance
    evals, evecs = np.linalg.eigh(cov)                            # ascending
    normals = evecs[:, :, 0]
    # deterministic orientation: first nonzero of (z, y, x) >= 0
    flip = np.where(
        normals[:, 2] != 0,
        np.sign(normals[:, 2]),
        np.where(normals[:, 1] != 0, np.sign(normals[:, 1]),
                 np.where(normals[:, 0] != 0, np.sign(normals[:, 0]), 1.0)),
    )
    normals = normals * flip[:, None]
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norms, 1e-12)


def _pair_features(
    p_s: np.ndarray, n_s: np.ndarray, p_t: np.ndarray, n_t: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(alpha, phi, theta, ok) for source/target arrays of shape (..., 3)
    — PCL ``computePairFeatures`` with the source/target swap applied."""
    d = p_t - p_s
    dist = np.linalg.norm(d, axis=-1)
    ok = dist > 1e-12
    dn = d / np.maximum(dist, 1e-12)[..., None]
    a1 = np.einsum("...i,...i->...", n_s, dn)
    a2 = np.einsum("...i,...i->...", n_t, dn)
    # swap so the source normal makes the smaller angle with the line
    swap = np.arccos(np.clip(np.abs(a1), 0, 1)) > np.arccos(
        np.clip(np.abs(a2), 0, 1)
    )
    u = np.where(swap[..., None], n_t, n_s)
    nt = np.where(swap[..., None], n_s, n_t)
    dn = np.where(swap[..., None], -dn, dn)
    phi = np.where(swap, a2 * -1.0, a1)
    # note: after the swap d points target->source, so phi = u . dn
    # equals the swapped a2 with flipped sign
    v = np.cross(dn, u)
    vn = np.linalg.norm(v, axis=-1)
    ok = ok & (vn > 1e-12)
    v = v / np.maximum(vn, 1e-12)[..., None]
    w = np.cross(u, v)
    alpha = np.einsum("...i,...i->...", v, nt)
    theta = np.arctan2(
        np.einsum("...i,...i->...", w, nt), np.einsum("...i,...i->...", u, nt)
    )
    return alpha, phi, theta, ok


def _bin33(alpha, phi, theta, ok, weights, n_points) -> np.ndarray:
    """Accumulate weighted (alpha, phi, theta) triples into per-point
    33-bin histograms. ``alpha/phi/theta/ok/weights`` are (N, K);
    returns (N, 33)."""
    n, k = alpha.shape
    b1 = np.clip((_NBINS * 0.5 * (alpha + 1.0)).astype(np.int64), 0, _NBINS - 1)
    b2 = np.clip((_NBINS * 0.5 * (phi + 1.0)).astype(np.int64), 0, _NBINS - 1)
    b3 = np.clip(
        (_NBINS * 0.5 * (theta / np.pi + 1.0)).astype(np.int64), 0, _NBINS - 1
    )
    hist = np.zeros((n, FPFH_DIM), np.float64)
    rows = np.repeat(np.arange(n), k)
    wf = (weights * ok).ravel()
    for off, bins in ((0, b1), (_NBINS, b2), (2 * _NBINS, b3)):
        np.add.at(hist, (rows, (bins + off).ravel()), wf)
    return hist


def compute_fpfh(
    points: np.ndarray,
    radius_normal: float = 0.05,
    radius_feature: float = 0.05,
    max_nn_normal: int = 30,
    max_nn_feature: int = 100,
    normals: Optional[np.ndarray] = None,
    use_native: bool = True,
) -> np.ndarray:
    """``(N, 3)`` cloud -> ``(N, 33)`` FPFH features (float64, like the
    open3d Feature matrix the reference caches).

    Runs the threaded C++ implementation (:mod:`.fpfh_native`, the same
    formulation: within 1e-9 of this route's per-row 11-bin group sums,
    rows equal but where a pair sits on a decision boundary; see
    ``csrc/fpfh.cc``) unless ``use_native=False`` or ``PCR_FPFH_NATIVE=0``
    choose this numpy route, the semantics oracle. A native route that
    does not build raises ``RuntimeError`` with g++'s message."""
    if use_native and os.environ.get("PCR_FPFH_NATIVE", "1") != "0":
        from . import fpfh_native

        return fpfh_native.compute_fpfh_native(
            points, radius_normal, radius_feature,
            max_nn_normal, max_nn_feature, normals=normals,
        )
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    if n == 0:
        return np.zeros((0, FPFH_DIM), np.float64)
    if normals is None:
        normals = estimate_normals(pts, radius_normal, max_nn_normal)
    idx, valid, sqd = _hybrid_neighbors(pts, radius_feature, max_nn_feature)
    # drop the self column (distance 0, sorted first)
    idx_n, valid_n, sqd_n = idx[:, 1:], valid[:, 1:], sqd[:, 1:]
    # also guard exact-duplicate points (distance 0 but not self)
    valid_n = valid_n & (sqd_n > 1e-24)
    if idx_n.shape[1] == 0:
        return np.zeros((n, FPFH_DIM), np.float64)

    p_s = np.broadcast_to(pts[:, None, :], idx_n.shape + (3,))
    n_s = np.broadcast_to(normals[:, None, :], idx_n.shape + (3,))
    p_t, n_t = pts[idx_n], normals[idx_n]
    alpha, phi, theta, ok = _pair_features(p_s, n_s, p_t, n_t)
    ok = ok & valid_n
    n_pairs = np.maximum(ok.sum(1), 1)                            # (N,)
    spfh = _bin33(alpha, phi, theta, ok, (100.0 / n_pairs)[:, None] * np.ones_like(alpha), n)

    # FPFH: self SPFH + per-group-normalised 1/d^2-weighted neighbour sum
    w = np.where(valid_n, 1.0 / np.maximum(sqd_n, 1e-24), 0.0)    # (N, K-1)
    nbr_spfh = spfh[idx_n]                                        # (N, K-1, 33)
    weighted = np.einsum("nk,nkd->nd", w, nbr_spfh)
    group_sums = weighted.reshape(n, 3, _NBINS).sum(-1)           # (N, 3)
    scale = np.where(group_sums > 0, 100.0 / np.maximum(group_sums, 1e-24), 0.0)
    fpfh = spfh + (weighted.reshape(n, 3, _NBINS) * scale[..., None]).reshape(
        n, FPFH_DIM
    )
    return fpfh
