"""Model factory, as the reference's model_type strings dispatch
(``patchaugnet_tpu/models/__init__.py``): PatchAugNet, PPT-Net (with and
without the normalised descriptor), PointNetVLAD and MinkLoc3Dv2 (its
sparse backend by default, the dense one with ``backend: dense`` or a
``grid_size``)."""
from typing import Any, Dict

from torch import nn

from ..nn.core import compute_dtype
from .backbone import MSGLevelOutput, PointNet2SAModuleMSG
from .patch_aug_net import PatchAugNet, PatchAugNetOutput, PatchData
from .minkloc3dv2 import MinkLoc3Dv2, build_minkloc
from .pointnet_vlad import PointNetFeat, PointNetVLAD
from .pptnet import PPTNet, PPTNetOutput


def get_model(model_type: str, param: Dict[str, Any]) -> nn.Module:
    """Build a model by the reference's model_type string."""
    if model_type == "pptnet":
        return PPTNet(param=param, use_normalize=False)
    if model_type == "pptnet_l2_norm":
        return PPTNet(param=param, use_normalize=True)
    if model_type == "pointnet_vlad":
        return PointNetVLAD(output_dim=param["FEATURE_OUTPUT_DIM"], compute_dtype=compute_dtype(param))
    if model_type == "patch_aug_net":
        return PatchAugNet(param=param, use_a2a_recon=param.get("use_patch_recon", True))
    if model_type == "minkloc3dv2":
        return build_minkloc(param)
    raise ValueError(f"unknown model_type: {model_type}")


__all__ = ["get_model", "PatchAugNet", "PatchAugNetOutput", "PatchData", "PPTNet", "PPTNetOutput",
           "PointNetVLAD", "PointNetFeat", "MinkLoc3Dv2", "build_minkloc",
           "PointNet2SAModuleMSG", "MSGLevelOutput"]
