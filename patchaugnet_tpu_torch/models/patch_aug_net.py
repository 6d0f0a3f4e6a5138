"""PatchAugNet (channels-last).

Port of ``patchaugnet_tpu/models/patch_aug_net.py``: three SA levels
(FPS -> kNN -> EdgeConv group -> SharedMLP -> max-pool), index provenance
back to the input cloud, three FP levels (3-NN interpolation ->
SharedMLP), the spatial-pyramid NetVLAD head (APFA2 by default), and the
patch branch of the train step (``with_patches``): the level-1 origin
patches, the L2-normalised patch features and, with a decoder, the
reconstructed patches, for all clouds or for the ``patch_rows`` subset.

``COMPUTE_DTYPE`` (``"bfloat16"``) runs the feature path at that dtype:
the SharedMLPs, the feature gathers and the VLAD cores' products, with f32
parameters, accumulation and BatchNorm statistics and normalisation;
FPS, the kNN and the 3-NN run on the f32 xyz, so every index is the f32
path's; the descriptor and ``fp_features`` come back f32, so the patch
branch, its decoder and the losses are f32. ``KNN_APPROX_RECALL`` runs the
exact kNN (``ops.knn``).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from .. import ops
from ..nn import PointNetDecoder, SpatialPyramidNetVLAD, l2_normalize
from ..nn.core import compute_dtype
from .backbone import PointNet2FPModule, PointNet2SAModule, index_provenance

# SA output widths (reference patch_aug_net.py:124-132)
SA_WIDTHS = ([32, 32, 64], [64, 64, 256], [256, 256, 512])


class PatchData(NamedTuple):
    """Per-cloud patch tensors (level-1 patches, one per SA0 centre)."""

    center_indices: torch.Tensor        # (R, 1024) original-cloud centre indices
    origin_patches: torch.Tensor        # (R, 1024, nsample, 3) raw grouped xyz
    patch_features: torch.Tensor        # (R, 1024, 256) L2-normalised
    reconstructed_patches: Optional[torch.Tensor]  # (R, 1024, nsample, 3)


class PatchAugNetOutput(NamedTuple):
    global_desc: torch.Tensor           # (B, D)
    fp_features: List[torch.Tensor]     # [(B,128,C), (B,1024,C), (B,4096,C)]
    center_idx_origin: List[torch.Tensor]
    sample_idx_origin: List[torch.Tensor]
    patch_data: Optional[PatchData] = None


class PatchAugNet(nn.Module):
    """``(B, N, 3) -> PatchAugNetOutput``.

    ``param`` holds the model keys of ``configs/patch_aug_net.yaml``
    (``configs.PATCH_AUG_NET`` at full width). Submodule names follow the
    JAX variable tree: ``sa{i}``, ``fp{i}``, ``aggregation``, ``decoder``.
    The VLAD weights start uninitialised: fill the model with
    ``compat.load_jax_variables`` or ``nn.seeded_init_``.

    ``use_a2a_recon`` adds the patch decoder. A JAX model creates its
    decoder only when it is initialised with patches, so the default
    keeps none, and a model built for serving takes a JAX tree without
    one; ``get_model`` passes the config's ``use_patch_recon``, as the JAX
    factory does. The decoder is registered last, so ``nn.seeded_init_``
    gives every other module the same values with or without it.
    """

    def __init__(self, param: Dict[str, Any], use_a2a_recon: bool = False):
        super().__init__()
        sap, knn, dil = param["SAMPLING"], param["KNN"], param.get("KNN_DILATION", 1)
        fs = param["FEATURE_SIZE"]
        self.use_origin_pc_in_fp = param.get("USE_ORIGIN_PC_IN_FP", True)
        self.compute_dtype = cdt = compute_dtype(param)

        in_w = 3
        for i, widths in enumerate(SA_WIDTHS):
            setattr(self, f"sa{i}", PointNet2SAModule(sap[i], knn[i], in_w, widths, knn_dilation=dil, dtype=cdt,
                                                      knn_approx_recall=param.get("KNN_APPROX_RECALL")))
            in_w = widths[-1]
        # FP levels (reference patch_aug_net.py:137-139), input = known ++ unknown widths
        self.fp2 = PointNet2FPModule(SA_WIDTHS[2][-1] + SA_WIDTHS[1][-1], [256, fs[2]], cdt)
        self.fp1 = PointNet2FPModule(fs[2] + SA_WIDTHS[0][-1], [256, fs[1]], cdt)
        self.fp0 = PointNet2FPModule(fs[1] + (3 if self.use_origin_pc_in_fp else 0), [256, 256, fs[0]], cdt)
        self.aggregation = SpatialPyramidNetVLAD(
            feature_size=fs,
            cluster_size=param["CLUSTER_SIZE"],
            output_dim=param["OUTPUT_DIM"],
            gating=param.get("GATING", False),
            aggregation_type=param.get("AGGREGATION_TYPE", 2),
            dtype=cdt,
        )
        self.decoder = PointNetDecoder(fs[1], knn[0]) if use_a2a_recon else None

    def forward(
        self, x: torch.Tensor, *, with_patches: bool = False, patch_rows: Optional[torch.Tensor] = None
    ) -> PatchAugNetOutput:
        """``patch_rows``: optional ``(R,)`` integer ids of the clouds whose
        patches the branch computes (the train step's queries and
        positives); ``None`` takes every cloud. Ignored without
        ``with_patches``."""
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
        center_origin, sample_origin = index_provenance(center_idx, sample_idx)

        for i in range(2, -1, -1):
            unknown = l_feats[i]
            if i == 0 and not self.use_origin_pc_in_fp:
                unknown = None
            l_feats[i] = getattr(self, f"fp{i}")(l_xyz[i], l_xyz[i + 1], unknown, l_feats[i + 1])

        # coarse -> fine, as the reference returns them: [128-pt, 1024-pt, 4096-pt]
        fp_features = [l_feats[2], l_feats[1], l_feats[0]]
        desc = self.aggregation(fp_features)
        if self.compute_dtype is not None:
            desc = desc.to(torch.float32)
            fp_features = [f.to(torch.float32) for f in fp_features]
        patch_data = None
        if with_patches:
            patch_data = self._patches(x, center_origin[0], sample_origin[0], fp_features[1], patch_rows)
        return PatchAugNetOutput(desc, fp_features, center_origin, sample_origin, patch_data)

    def _patches(self, xyz, center0, sample0, pf, patch_rows) -> PatchData:
        """The level-1 patch branch (JAX ``patch_aug_net.py:153-176``)."""
        if patch_rows is not None:
            rows = patch_rows.to(torch.int64)
            xyz, center0, sample0, pf = xyz[rows], center0[rows], sample0[rows], pf[rows]
        origin_patches = ops.group(xyz, sample0)            # (R, 1024, k, 3)
        pf = l2_normalize(pf, dim=-1)
        recon = None
        if self.decoder is not None:
            r, m, c = pf.shape
            recon = self.decoder(pf.reshape(r * m, c)).reshape(r, m, self.decoder.num_points, 3)
        return PatchData(center0, origin_patches, pf, recon)
