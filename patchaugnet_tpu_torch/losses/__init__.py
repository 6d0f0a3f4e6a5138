"""Losses: the metric losses on global descriptors (``metric.py``), the
patch feature contrast (``patch_contrast.py``) and the reconstruction
losses (``recon.py``), with the reference's string dispatch."""
from .metric import (
    best_pos_distance,
    hphn_quadruplet_loss,
    quadruplet_loss,
    triplet_loss,
    triplet_loss_wrapper,
)
from .patch_contrast import PatchCorrespondences, contrastive_loss, patch_contrastive_loss
from .recon import (
    chamfer_l1_masked,
    chamfer_loss,
    emd_loss,
    patch_chamfer_loss,
    patch_emd_loss,
    point_pair_loss,
)


def get_loss_func(loss_type: str):
    """String-keyed dispatch (reference ``get_loss_func``,
    ``train_place_recognition.py:102-120``); unknown names take the
    triplet loss."""
    table = {
        "quadruplet": quadruplet_loss,
        "hphn_quadruplet": hphn_quadruplet_loss,
        "contrastive": contrastive_loss,
        "chamfer": chamfer_loss,
        "patch_chamfer": patch_chamfer_loss,
        "emd": emd_loss,
        "patch_emd": patch_emd_loss,
        "point_pair": point_pair_loss,
    }
    return table.get(loss_type, triplet_loss_wrapper)


__all__ = [
    "best_pos_distance",
    "triplet_loss",
    "triplet_loss_wrapper",
    "quadruplet_loss",
    "hphn_quadruplet_loss",
    "chamfer_loss",
    "chamfer_l1_masked",
    "emd_loss",
    "point_pair_loss",
    "patch_chamfer_loss",
    "patch_emd_loss",
    "PatchCorrespondences",
    "patch_contrastive_loss",
    "contrastive_loss",
    "get_loss_func",
]
