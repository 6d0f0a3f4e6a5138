"""Building blocks of the port's models (torch modules), and the
auxiliary blocks of the rerank and pose-estimation library (``extras``).
Two public names differ from the JAX package's: its functional
``batch_norm`` is the module :class:`BatchNorm` here, and its
``nn_angle_jax`` is :func:`nn_angle`."""
from .core import (BN_EPS, BN_MOMENTUM, MLP, BatchNorm, SharedMLP, l2_normalize, seeded_init_,
                   training_init_)
from .pointnet import STN3D, PointNetAutoencoder, PointNetDecoder, PointNetEncoder
from .attention import SA, AdaptiveFeatureAggregator, GroupedDense, GroupSA, MLPAttention
from .vlad import GatingContext, NetVLADBase, NetVLADLoupe, PPTSpatialPyramidNetVLAD, SpatialPyramidNetVLAD
from .extras import (
    CBAM,
    AbsCoordEncoder,
    AngleEncoder,
    AttentionalGNN,
    ChannelAttention,
    DistanceEncoder,
    GeMPooling,
    GeoEncoder,
    MultiheadAttention,
    PairwiseFeatProcessor,
    SEAttention,
    SingleFeatProcessor,
    SpatialAttention,
    TransformerEncoderLayer,
    nn_angle,
    sinusoidal_positional_embedding,
)

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
    "SEAttention",
    "ChannelAttention",
    "SpatialAttention",
    "CBAM",
    "GeMPooling",
    "sinusoidal_positional_embedding",
    "MultiheadAttention",
    "TransformerEncoderLayer",
    "AttentionalGNN",
    "AbsCoordEncoder",
    "DistanceEncoder",
    "AngleEncoder",
    "GeoEncoder",
    "SingleFeatProcessor",
    "PairwiseFeatProcessor",
    "nn_angle",
]
