"""Losses. Ported so far: the reconstruction losses (``recon.py``)."""
from .recon import (
    chamfer_l1_masked,
    chamfer_loss,
    emd_loss,
    patch_chamfer_loss,
    patch_emd_loss,
    point_pair_loss,
)

__all__ = [
    "chamfer_loss",
    "chamfer_l1_masked",
    "emd_loss",
    "point_pair_loss",
    "patch_chamfer_loss",
    "patch_emd_loss",
]
