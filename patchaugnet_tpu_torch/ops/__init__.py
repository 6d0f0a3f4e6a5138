"""Fixed-shape point-cloud ops, channels-last.

Port of ``patchaugnet_tpu.ops``, all of its public names: plain torch ops,
with hand-written CUDA kernels (``csrc/``) for farthest point sampling
(``fps``), kNN (``knn``, also under ``knn_exclude_self``, the 3-NN and
the kNN groupings), top-k extraction, plain and price-fused (``topk``,
used by the auction EMD in ``emd``), and eval BatchNorm with ReLU in one
pass (``norm``, a kernel of the port alone). Each kernel wrapper launches its
kernel for a CUDA tensor and runs its plain torch version for a CPU
tensor. The ball query and the label statistics are torch ops, as they
are XLA in the JAX package.
"""
from .pairwise import pairwise_sqdist, self_sqdist
from .fps import farthest_point_sample
from .knn import ball_query, dilated_knn, knn, knn_exclude_self
from .topk import topk_extract, topk_extract_chunked, topk_extract_pair, topk_extract_price
from .norm import bn_relu
from .grouping import (
    GroupedEdgeFeatures,
    gather,
    group,
    group_all,
    interpolate_features,
    query_and_group,
    query_and_group_edge,
    three_interpolate,
    three_nn,
)
from .chamfer import chamfer_sqdists, chamfer_l1, chamfer_l2, chamfer_l2_split
from .emd import auction_emd
from .labelstat import (
    featuredistribute,
    featuregather,
    labelstat_and_ballquery,
    labelstat_ballrange,
    labelstat_idx,
)

__all__ = [
    "pairwise_sqdist",
    "self_sqdist",
    "farthest_point_sample",
    "knn",
    "dilated_knn",
    "ball_query",
    "knn_exclude_self",
    "topk_extract",
    "topk_extract_chunked",
    "topk_extract_pair",
    "topk_extract_price",
    "gather",
    "group",
    "three_nn",
    "three_interpolate",
    "interpolate_features",
    "query_and_group",
    "query_and_group_edge",
    "group_all",
    "GroupedEdgeFeatures",
    "chamfer_sqdists",
    "chamfer_l1",
    "chamfer_l2",
    "chamfer_l2_split",
    "auction_emd",
    "labelstat_ballrange",
    "labelstat_idx",
    "labelstat_and_ballquery",
    "featuredistribute",
    "featuregather",
    "bn_relu",
]
