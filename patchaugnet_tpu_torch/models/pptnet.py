"""PPT-Net (channels-last).

Port of ``patchaugnet_tpu/models/pptnet.py`` (reference
``pptnet_origin/models/pptnet.py``): a four-level PointNet++ (4096 ->
1024 -> 256 -> 64 -> 16 points at the shipped config) with grouped
self-attention after every SA max-pool, four FP levels, and the
four-scale PPT spatial-pyramid NetVLAD head. ``use_normalize`` tells the
``pptnet`` (un-normalised) and ``pptnet_l2_norm`` model types apart.
``COMPUTE_DTYPE`` and ``KNN_APPROX_RECALL`` as in PatchAugNet
(``models/patch_aug_net.py``): the feature path, ``GroupSA`` included, at
the compute dtype, the geometry f32, the descriptor and ``fp_features``
f32; the exact kNN.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch
from torch import nn

from ..nn import PPTSpatialPyramidNetVLAD, l2_normalize
from ..nn.core import compute_dtype
from .backbone import PointNet2FPModule, PointNet2SAModule, index_provenance

# SA output widths (reference pptnet.py:76-83)
SA_WIDTHS = ([32, 32, 64], [64, 64, 128], [128, 128, 256], [256, 256, 512])


class PPTNetOutput(NamedTuple):
    global_desc: torch.Tensor           # (B, D)
    fp_features: List[torch.Tensor]     # [(B, 64, C), (B, 256, C), (B, 1024, C), (B, 4096, C)]
    center_idx_origin: List[torch.Tensor]


class PPTNet(nn.Module):
    """``(B, N, 3) -> PPTNetOutput``.

    ``param`` holds the model keys of ``configs/pptnet_origin.yaml``
    (``configs.PPTNET_ORIGIN``): SAMPLING, KNN, FEATURE_SIZE, CLUSTER_SIZE,
    OUTPUT_DIM, GROUP, GATING. Submodule names follow the JAX variable
    tree: ``sa{i}`` (with its attention ``sa{i}.sa``), ``fp{i}``,
    ``aggregation``. The kNN takes no dilation. The VLAD weights start
    uninitialised: fill the model with ``compat.load_jax_variables`` or
    ``nn.seeded_init_``.
    """

    def __init__(self, param: Dict[str, Any], use_normalize: bool = True):
        super().__init__()
        self.use_normalize = use_normalize
        self.compute_dtype = cdt = compute_dtype(param)
        sap, knn, fs, gp = param["SAMPLING"], param["KNN"], param["FEATURE_SIZE"], param["GROUP"]
        in_w = 3                                           # level-0 features are the xyz
        for i, widths in enumerate(SA_WIDTHS):
            setattr(self, f"sa{i}", PointNet2SAModule(sap[i], knn[i], in_w, widths, gp=gp, dtype=cdt,
                                                      knn_approx_recall=param.get("KNN_APPROX_RECALL")))
            in_w = widths[-1]
        # FP levels (reference pptnet.py:85-88), input = known ++ unknown widths;
        # they run from fp3 down to fp0
        self.fp3 = PointNet2FPModule(SA_WIDTHS[3][-1] + SA_WIDTHS[2][-1], [256, fs[3]], cdt)
        self.fp2 = PointNet2FPModule(fs[3] + SA_WIDTHS[1][-1], [256, fs[2]], cdt)
        self.fp1 = PointNet2FPModule(fs[2] + SA_WIDTHS[0][-1], [256, fs[1]], cdt)
        self.fp0 = PointNet2FPModule(fs[1] + 3, [256, 256, fs[0]], cdt)
        self.aggregation = PPTSpatialPyramidNetVLAD(
            feature_size=fs,
            cluster_size=param["CLUSTER_SIZE"],
            output_dim=param["OUTPUT_DIM"],
            gating=param["GATING"],
            dtype=cdt,
        )

    def forward(self, x: torch.Tensor) -> PPTNetOutput:
        if x.dim() == 4:
            x = x.squeeze(1)
        l_xyz, l_feats = [x], [x]
        center_idx, sample_idx = [], []
        for i in range(len(SA_WIDTHS)):
            out = getattr(self, f"sa{i}")(l_xyz[i], l_feats[i])
            l_xyz.append(out.new_xyz)
            l_feats.append(out.features)
            center_idx.append(out.center_idx)
            sample_idx.append(out.sample_idx)
        center_origin, _ = index_provenance(center_idx, sample_idx)

        for i in range(len(SA_WIDTHS) - 1, -1, -1):
            l_feats[i] = getattr(self, f"fp{i}")(l_xyz[i], l_xyz[i + 1], l_feats[i], l_feats[i + 1])

        # coarse -> fine, paired with MAX_SAMPLES [64, 256, 1024, 4096]
        fp_features = [l_feats[3], l_feats[2], l_feats[1], l_feats[0]]
        desc = self.aggregation(fp_features)
        if self.use_normalize:
            desc = l2_normalize(desc, dim=-1)
        if self.compute_dtype is not None:
            desc = desc.to(torch.float32)
            fp_features = [f.to(torch.float32) for f in fp_features]
        return PPTNetOutput(desc, fp_features, center_origin)
