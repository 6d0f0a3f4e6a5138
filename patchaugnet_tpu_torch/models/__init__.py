"""Model factory (only PatchAugNet is ported so far)."""
from typing import Any, Dict

from .patch_aug_net import PatchAugNet, PatchAugNetOutput, PatchData


def get_model(model_type: str, param: Dict[str, Any]) -> PatchAugNet:
    """Build a model by the reference's model_type string."""
    if model_type == "patch_aug_net":
        return PatchAugNet(param=param, use_a2a_recon=param.get("use_patch_recon", True))
    raise ValueError(f"model_type {model_type!r}: not ported yet")


__all__ = ["get_model", "PatchAugNet", "PatchAugNetOutput", "PatchData"]
