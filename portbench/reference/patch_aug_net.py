"""Plain reference of PatchAugNet (the published model, ``configs/patch_aug_net.yaml``).

Three set-abstraction levels with EdgeConv grouping (SA widths of the
published model), three feature-propagation levels (the raw cloud joins
the last), the spatial-pyramid NetVLAD over the 128-, 1024- and 4096-point
features with APFA2 (aggregation type 2: the three VLADs' clusters
side by side through one adaptive feature aggregation), and, for
training, the level-1 patch branch: the raw neighbourhoods of SA0's
centres, the L2-normalised 1024-point features and the patch decoder
(FC 1024, FC 1024, FC to ``KNN[0]`` points, tanh).

The kNN's dilation draws its k neighbours from the first k of the
dilated candidates, which are the k nearest: the kNN itself.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from .common import (Net, afa, bn_spec, fp_level, gather, l2n, mlp_spec, netvlad, sa_level,
                     vlad_spec)

SA_WIDTHS = ([32, 32, 64], [64, 64, 256], [256, 256, 512])
DECODER_WIDTH = 1024


class TrainOutput(NamedTuple):
    desc: torch.Tensor                 # (B, D)
    origin_patches: torch.Tensor       # (R, 1024, k, 3)
    patch_features: torch.Tensor       # (R, 1024, C)
    recon: torch.Tensor                # (R, 1024, k, 3)


def _fp_widths(cfg):
    fs = cfg["FEATURE_SIZE"]
    return [(SA_WIDTHS[2][-1] + SA_WIDTHS[1][-1], [256, fs[2]]),
            (fs[2] + SA_WIDTHS[0][-1], [256, fs[1]]),
            (fs[1] + 3, [256, 256, fs[0]])]          # fp2, fp1, fp0


def spec(cfg: Dict[str, Any]):
    """Names and shapes of every parameter and statistic."""
    out, in_w = [], 3
    for i, widths in enumerate(SA_WIDTHS):
        out += mlp_spec(f"sa{i}.mlp", widths, in_w + 3)
        in_w = widths[-1]
    for i, (w_in, widths) in zip((2, 1, 0), _fp_widths(cfg)):
        out += mlp_spec(f"fp{i}.mlp", widths, w_in)
    fs, ks, ds = cfg["FEATURE_SIZE"], cfg["CLUSTER_SIZE"], cfg["OUTPUT_DIM"]
    for i in range(len(fs)):
        out += vlad_spec(f"aggregation.vlad{i}", fs[i], ks[i])
    d0 = ds[0]
    out += [("aggregation.afa.mlpa.mlp0.weight", (d0, d0)),
            ("aggregation.afa.fc.weight", (d0, d0 * sum(ks))), ("aggregation.afa.fc.bias", (d0,))]
    out += bn_spec("aggregation.afa.bn", d0)
    if cfg.get("use_patch_recon", False):
        k = cfg["KNN"][0]
        out += [("decoder.fc1.weight", (DECODER_WIDTH, fs[1])), ("decoder.fc1.bias", (DECODER_WIDTH,))]
        out += bn_spec("decoder.bn1", DECODER_WIDTH)
        out += [("decoder.fc2.weight", (DECODER_WIDTH, DECODER_WIDTH)), ("decoder.fc2.bias", (DECODER_WIDTH,))]
        out += bn_spec("decoder.bn2", DECODER_WIDTH)
        out += [("decoder.fc3.weight", (k * 3, DECODER_WIDTH)), ("decoder.fc3.bias", (k * 3,))]
    return out


def forward(net: Net, cfg: Dict[str, Any], x: torch.Tensor, patch_rows: Optional[torch.Tensor] = None):
    """Global descriptors ``(B, D)``; with ``patch_rows`` (the clouds of the
    patch branch) a :class:`TrainOutput`."""
    if cfg.get("AGGREGATION_TYPE", 2) != 2 or cfg.get("GATING", False):
        raise ValueError("the reference holds the published head: APFA2 (AGGREGATION_TYPE 2), no gating")
    xyz, feats = [x], [x]
    centers, samples = [], []
    for i, widths in enumerate(SA_WIDTHS):
        new_xyz, h, center, idx = sa_level(net, f"sa{i}", xyz[i], feats[i], cfg["SAMPLING"][i], cfg["KNN"][i],
                                           len(widths))
        xyz.append(new_xyz)
        feats.append(h)
        centers.append(center)
        samples.append(idx)
    for i, (_, widths) in zip((2, 1, 0), _fp_widths(cfg)):
        feats[i] = fp_level(net, f"fp{i}", xyz[i], xyz[i + 1], feats[i], feats[i + 1], len(widths))
    fp_features = [feats[2], feats[1], feats[0]]
    vlads = [netvlad(net, f"aggregation.vlad{i}", f) for i, f in enumerate(fp_features)]
    desc = afa(net, "aggregation.afa", torch.cat(vlads, dim=-1).transpose(-1, -2))
    if patch_rows is None:
        return desc
    rows = patch_rows
    origin = gather(x[rows], samples[0][rows])                     # (R, 1024, k, 3)
    pf = l2n(fp_features[1][rows])
    r, m, c = pf.shape
    h = torch.relu(net.bn(net.linear(pf.reshape(r * m, c), "decoder.fc1", bias=True), "decoder.bn1"))
    h = torch.relu(net.bn(net.linear(h, "decoder.fc2", bias=True), "decoder.bn2"))
    recon = torch.tanh(net.linear(h, "decoder.fc3", bias=True)).reshape(r, m, -1, 3)
    return TrainOutput(desc, origin, pf, recon)
