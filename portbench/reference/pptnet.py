"""Plain reference of PPT-Net (the published model, ``configs/pptnet_origin.yaml``).

Four set-abstraction levels with kNN grouping (no dilation), each
followed by grouped self-attention with tied queries and keys (``GROUP``
groups), four feature-propagation levels, and the pyramid VLAD: the four
VLADs flattened channel-major side by side, one product, BatchNorm and
context gating. ``model_type`` ``pptnet`` returns that descriptor as it
is, ``pptnet_l2_norm`` L2-normalises it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import Net, bn_spec, context_gating, fp_level, l2n, mlp_spec, netvlad, sa_level, vlad_spec

SA_WIDTHS = ([32, 32, 64], [64, 64, 128], [128, 128, 256], [256, 256, 512])


def _fp_widths(cfg):
    fs = cfg["FEATURE_SIZE"]
    return [(SA_WIDTHS[3][-1] + SA_WIDTHS[2][-1], [256, fs[3]]),
            (fs[3] + SA_WIDTHS[1][-1], [256, fs[2]]),
            (fs[2] + SA_WIDTHS[0][-1], [256, fs[1]]),
            (fs[1] + 3, [256, 256, fs[0]])]          # fp3 .. fp0


def spec(cfg: Dict[str, Any]):
    """Names and shapes of every parameter and statistic."""
    out, in_w, gp = [], 3, cfg["GROUP"]
    for i, widths in enumerate(SA_WIDTHS):
        c = widths[-1]
        out += mlp_spec(f"sa{i}.mlp", widths, in_w + 3)
        out += [(f"sa{i}.sa.qk_conv.kernel", (gp, c // gp, c // gp)),
                (f"sa{i}.sa.v_conv.weight", (c, c)), (f"sa{i}.sa.v_conv.bias", (c,)),
                (f"sa{i}.sa.trans_conv.weight", (c, c)), (f"sa{i}.sa.trans_conv.bias", (c,))]
        out += bn_spec(f"sa{i}.sa.after_norm", c)
        in_w = c
    for i, (w_in, widths) in zip((3, 2, 1, 0), _fp_widths(cfg)):
        out += mlp_spec(f"fp{i}.mlp", widths, w_in)
    fs, ks, ds = cfg["FEATURE_SIZE"], cfg["CLUSTER_SIZE"], cfg["OUTPUT_DIM"]
    for i in range(len(fs)):
        out += vlad_spec(f"aggregation.vlad{i}", fs[i], ks[i])
    out += [("aggregation.hidden_weights", (fs[0] * sum(ks), ds[0]))] + bn_spec("aggregation.bn2", ds[0])
    if cfg["GATING"]:
        out += [("aggregation.context_gating.gating_weights", (ds[0], ds[0]))]
        out += bn_spec("aggregation.context_gating.bn1", ds[0])
    return out


def forward(net: Net, cfg: Dict[str, Any], x: torch.Tensor, patch_rows=None) -> torch.Tensor:
    """Global descriptors ``(B, D)``."""
    if patch_rows is not None:
        raise ValueError("PPT-Net has no patch branch")
    xyz, feats = [x], [x]
    for i, widths in enumerate(SA_WIDTHS):
        new_xyz, h, _, _ = sa_level(net, f"sa{i}", xyz[i], feats[i], cfg["SAMPLING"][i], cfg["KNN"][i],
                                    len(widths), attention_groups=cfg["GROUP"])
        xyz.append(new_xyz)
        feats.append(h)
    for i, (_, widths) in zip((3, 2, 1, 0), _fp_widths(cfg)):
        feats[i] = fp_level(net, f"fp{i}", xyz[i], xyz[i + 1], feats[i], feats[i + 1], len(widths))
    flats = [netvlad(net, f"aggregation.vlad{i}", f).reshape(x.shape[0], -1)
             for i, f in enumerate([feats[3], feats[2], feats[1], feats[0]])]
    desc = net.bn(net.matmul(torch.cat(flats, dim=-1), net.p["aggregation.hidden_weights"]), "aggregation.bn2")
    if cfg["GATING"]:
        desc = context_gating(net, "aggregation.context_gating", desc)
    if cfg["model_type"] == "pptnet_l2_norm":
        desc = l2n(desc)
    return desc
