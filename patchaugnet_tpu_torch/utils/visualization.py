"""Offline analysis / visualisation.

Port of ``patchaugnet_tpu/utils/visualization.py``, the replacements for
the reference's analysis layer:
  - recall/precision curve plots    <- utils/draw_result.py (minus the
    hard-coded paper tables at :337-1446 — plots are generated from live
    RecallResult data instead)
  - t-SNE feature colouring         <- utils/visualization.py:13-105
    (matplotlib scatter; the open3d interactive windows have no headless
    analogue and are not reproduced)
  - matplotlib point-cloud renders  <- cloud/patch figures in
    draw_result.py
  - pose-error comparison           <- utils/cmp_stat.py:7-66

The plots write files (headless-safe, Agg backend). matplotlib, and
sklearn for the t-SNE, are imported by the functions that draw, not by
the module: importing it and :func:`compare_pose_errors` need neither, and
a plot on a machine without matplotlib raises an ``ImportError`` that
names it.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend."""
    try:
        import matplotlib
    except ImportError:
        raise ImportError("plotting needs matplotlib, which is not installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
def plot_recall_curves(
    results: Dict[str, np.ndarray],
    out_path: str,
    title: str = "Recall@topN",
    ylabel: str = "Recall (%)",
) -> str:
    """Line chart of recall@1..N per method (draw_result.py figure style)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for name, recall in results.items():
        n = len(recall)
        ax.plot(range(1, n + 1), recall, marker="o", markersize=3, label=name)
    ax.set_xlabel("N - number of top candidates")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_tsne_features(
    features: np.ndarray,
    labels: Optional[np.ndarray],
    out_path: str,
    perplexity: float = 30.0,
    title: str = "t-SNE of descriptors",
) -> str:
    """2-D t-SNE scatter of descriptors coloured by label
    (visualization.py feature-map colouring). Needs sklearn too."""
    plt = _pyplot()
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        raise ImportError("the t-SNE plot needs sklearn (scikit-learn), which is not installed") from None

    emb = TSNE(
        n_components=2, perplexity=min(perplexity, max(len(features) // 4, 2)),
        init="pca", random_state=0,
    ).fit_transform(np.asarray(features))
    fig, ax = plt.subplots(figsize=(5, 5))
    sc = ax.scatter(
        emb[:, 0], emb[:, 1], c=labels if labels is not None else "tab:blue",
        cmap="tab20", s=8,
    )
    if labels is not None:
        fig.colorbar(sc, ax=ax, shrink=0.8)
    ax.set_title(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_clouds(
    clouds: Sequence[np.ndarray],
    out_path: str,
    labels: Optional[Sequence[str]] = None,
    elev: float = 30.0,
    azim: float = 45.0,
) -> str:
    """Side-by-side 3-D scatter renders (reconstruction figures)."""
    plt = _pyplot()
    n = len(clouds)
    fig = plt.figure(figsize=(4 * n, 4))
    for i, cloud in enumerate(clouds):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        c = np.asarray(cloud).reshape(-1, 3)
        ax.scatter(c[:, 0], c[:, 1], c[:, 2], s=1, c=c[:, 2], cmap="viridis")
        ax.view_init(elev=elev, azim=azim)
        if labels:
            ax.set_title(labels[i])
        ax.set_axis_off()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def compare_pose_errors(
    errors_a: Sequence[Tuple[float, float]],
    errors_b: Sequence[Tuple[float, float]],
    names: Tuple[str, str] = ("a", "b"),
) -> Dict[str, Dict[str, float]]:
    """RRE/RTE summary comparison (cmp_stat.py:7-66)."""
    out = {}
    for name, errs in zip(names, (errors_a, errors_b)):
        arr = np.asarray(errs, float)
        out[name] = {
            "rre_mean": float(arr[:, 0].mean()),
            "rre_median": float(np.median(arr[:, 0])),
            "rte_mean": float(arr[:, 1].mean()),
            "rte_median": float(np.median(arr[:, 1])),
            "n": len(arr),
        }
    return out
