"""Plain reference of the quadruplet tuple train step (the PatchAugNet
repository's ``train_place_recognition.py`` loop body).

One step: the train-mode forward (BatchNorm on batch statistics, running
statistics updated with momentum 0.9), the lazy quadruplet loss over the
tuple batch (query, positives, negatives, other negative), the L1
chamfer between the patch branch's raw and reconstructed patches, the a2b
patch contrast over the correspondence table (per pair the mean of
``||q - p||^2 + max(m1 - ||q - n||, 0)^2`` over its valid rows, the pairs
averaged), their weighted sum, its gradient, and one Adam update (betas
0.9 and 0.999, eps 1e-8, bias-corrected). A total of 1e-10 or less zeroes
the gradient and the update still runs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from .common import Net

STATS = ("running_mean", "running_var")
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


class Batch(NamedTuple):
    clouds: torch.Tensor      # (B*T, N, 3)
    mask: torch.Tensor        # (B*T,) bool: the clouds of the patch branch
    corr: Tuple[torch.Tensor, ...]   # q_cloud, n_cloud, q_idx, pos_idx, neg_idx, pair_id, valid
    num_pairs: int


def is_stat(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in STATS


def _sqdist_last(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(..., n, 3), (..., m, 3) -> (..., n, m)`` squared distances, clamped at 0."""
    d = None
    for c in range(3):
        diff = x[..., :, None, c] - y[..., None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d.clamp_min(0.0)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).expand(x.shape).to(x.dtype)
    return (x * m).sum() / torch.clamp_min(m.sum(), 1.0)


def quadruplet(desc: torch.Tensor, cfg: Dict[str, Any]) -> torch.Tensor:
    b, p, n = cfg["TRAIN_BATCH_SIZE"], cfg["TRAIN_POSITIVES_PER_QUERY"], cfg["TRAIN_NEGATIVES_PER_QUERY"]
    d = desc.reshape(b, 1 + p + n + 1, -1)
    q, pos, neg, other = d[:, :1], d[:, 1:1 + p], d[:, 1 + p:1 + p + n], d[:, 1 + p + n:]
    hardest_pos = ((pos - q) ** 2).sum(2).amax(dim=1)[:, None]
    first = torch.clamp_min(cfg["MARGIN_1"] + hardest_pos - ((neg - q) ** 2).sum(2), 0.0).amax(dim=1).mean()
    second = torch.clamp_min(cfg["MARGIN_2"] + hardest_pos - ((neg - other) ** 2).sum(2), 0.0).amax(dim=1).mean()
    return first + second


def patch_chamfer(origin: torch.Tensor, recon: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    d = _sqdist_last(origin, recon)
    return (_masked_mean(torch.sqrt(d.amin(dim=-1) + 1e-12), valid)
            + _masked_mean(torch.sqrt(d.amin(dim=-2) + 1e-12), valid)) / 2.0


def patch_contrast(pf: torch.Tensor, rows: torch.Tensor, valid_rows: torch.Tensor, batch: Batch,
                   margin: float) -> torch.Tensor:
    """The a2b contrast on the patch branch's features ``pf`` of the clouds ``rows``."""
    q_cloud, n_cloud, q_idx, pos_idx, neg_idx, pair_id, row_valid = (t.long() for t in batch.corr)
    total = batch.clouds.shape[0]
    where = torch.full((total,), -1, dtype=torch.long, device=pf.device)
    where[rows[valid_rows]] = torch.arange(rows.shape[0], device=pf.device)[valid_rows]
    ok = row_valid.bool() & (where[q_cloud] >= 0) & (where[n_cloud] >= 0)
    qr, nr = where[q_cloud].clamp_min(0), where[n_cloud].clamp_min(0)
    q, p, n = pf[qr, q_idx], pf[nr, pos_idx], pf[nr, neg_idx]
    qp = ((q - p) ** 2).sum(-1)
    qn = torch.clamp_min(margin - torch.sqrt(((q - n) ** 2).sum(-1) + 1e-12), 0.0) ** 2
    w = ok.to(pf.dtype)
    seg = lambda v: torch.zeros(batch.num_pairs, dtype=v.dtype, device=v.device).index_add(0, pair_id, v)
    cnt = seg(w)
    per_pair = (seg(qp * w) + seg(qn * w)) / torch.clamp_min(cnt, 1.0)
    has = (cnt > 0).to(pf.dtype)
    return (per_pair * has).sum() / torch.clamp_min(has.sum(), 1.0)


def patch_rows(mask: torch.Tensor, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``r`` clouds of ``mask`` (cloud 0 fills the rest) and which are real."""
    ids = torch.nonzero(mask).flatten()[:r]
    rows = torch.zeros(r, dtype=torch.long, device=mask.device)
    rows[:ids.shape[0]] = ids
    return rows, torch.arange(r, device=mask.device) < ids.shape[0]


def losses(forward: Callable, net: Net, cfg: Dict[str, Any], batch: Batch) -> Dict[str, torch.Tensor]:
    """The weighted terms and ``total`` of one step."""
    b, p = cfg["TRAIN_BATCH_SIZE"], cfg["TRAIN_POSITIVES_PER_QUERY"]
    use_a2a, use_a2b = cfg.get("use_patch_recon", False), cfg.get("use_patch_feature_contrast", False)
    if not (use_a2a or use_a2b):
        pr = cfg.get("weight_place_recognition", 1.0) * quadruplet(forward(net, cfg, batch.clouds), cfg)
        return {"place_recognition": pr, "total": pr}
    rows, valid = patch_rows(batch.mask, min(cfg.get("A2A_MAX_CLOUDS", b * (1 + p)), batch.clouds.shape[0]))
    out = forward(net, cfg, batch.clouds, patch_rows=rows)
    terms = {"place_recognition": cfg.get("weight_place_recognition", 1.0) * quadruplet(out.desc, cfg)}
    if use_a2a:
        terms["patch_recon_a2a"] = cfg.get("weight_patch_recon", 0.25) * patch_chamfer(
            out.origin_patches, out.recon, valid)
    if use_a2b:
        terms["patch_recon_a2b"] = cfg.get("weight_patch_feature_contrast", 0.25) * patch_contrast(
            out.patch_features, rows, valid, batch, cfg["MARGIN_1"])
    terms["total"] = sum(terms.values())
    return terms


def step(forward: Callable, state: Dict[str, Any], cfg: Dict[str, Any], batch: Batch, lr: float,
         tf32: bool = False) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """One step on ``state`` (``params``: every tensor by name; ``m``, ``v``:
    Adam's moments; ``t``: its count), updated in place. Returns the
    metrics and the gradient by name."""
    params = state["params"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items() if not is_stat(k)}
    net = Net({**params, **leaves}, train=True, tf32=tf32)
    terms = losses(forward, net, cfg, batch)
    names = sorted(leaves)
    grads = torch.autograd.grad(terms["total"], [leaves[k] for k in names], allow_unused=True)
    keep = bool(terms["total"].detach() > 1e-10)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None or not keep else g) for k, g in zip(names, grads)}
    state["t"] += 1
    t = state["t"]
    with torch.no_grad():
        for k in names:
            g = grads[k]
            m = state["m"].setdefault(k, torch.zeros_like(g))
            v = state["v"].setdefault(k, torch.zeros_like(g))
            m.mul_(BETA1).add_(g, alpha=1 - BETA1)
            v.mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            denom = (v.sqrt() / (1 - BETA2 ** t) ** 0.5).add_(ADAM_EPS)
            params[k] = params[k] - (lr / (1 - BETA1 ** t)) * m / denom
        params.update(net.updates)
    return {k: float(v.detach()) for k, v in terms.items()}, grads
