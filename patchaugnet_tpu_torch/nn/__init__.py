"""Building blocks of PatchAugNet (torch modules)."""
from .core import (BN_EPS, BN_MOMENTUM, MLP, BatchNorm, SharedMLP, l2_normalize, seeded_init_,
                   training_init_)
from .pointnet import PointNetDecoder
from .attention import AdaptiveFeatureAggregator, MLPAttention
from .vlad import GatingContext, NetVLADBase, SpatialPyramidNetVLAD

__all__ = [
    "BN_EPS",
    "BN_MOMENTUM",
    "BatchNorm",
    "SharedMLP",
    "MLP",
    "l2_normalize",
    "seeded_init_",
    "training_init_",
    "MLPAttention",
    "AdaptiveFeatureAggregator",
    "NetVLADBase",
    "GatingContext",
    "SpatialPyramidNetVLAD",
    "PointNetDecoder",
]
