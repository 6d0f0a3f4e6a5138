"""Building blocks of the port's models (torch modules)."""
from .core import (BN_EPS, BN_MOMENTUM, MLP, BatchNorm, SharedMLP, l2_normalize, seeded_init_,
                   training_init_)
from .pointnet import STN3D, PointNetAutoencoder, PointNetDecoder, PointNetEncoder
from .attention import SA, AdaptiveFeatureAggregator, GroupedDense, GroupSA, MLPAttention
from .vlad import GatingContext, NetVLADBase, NetVLADLoupe, PPTSpatialPyramidNetVLAD, SpatialPyramidNetVLAD

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
    "PPTSpatialPyramidNetVLAD",
    "NetVLADLoupe",
    "GroupedDense",
    "GroupSA",
    "SA",
    "STN3D",
    "PointNetEncoder",
    "PointNetDecoder",
    "PointNetAutoencoder",
]
