"""Fixed-shape point-cloud ops, channels-last.

Port of ``patchaugnet_tpu.ops`` for the descriptor forward and the
reconstruction losses: plain torch ops, with hand-written CUDA kernels
(``csrc/``) for farthest point sampling (``fps``), kNN (``knn``) and top-k
extraction, plain and price-fused (``topk``, used by the auction EMD in
``emd``). Each kernel wrapper launches its kernel for a CUDA tensor and
runs its plain torch version for a CPU tensor.
"""
from .pairwise import pairwise_sqdist
from .fps import farthest_point_sample
from .knn import knn, dilated_knn
from .topk import topk_extract, topk_extract_chunked, topk_extract_pair, topk_extract_price
from .grouping import (
    GroupedEdgeFeatures,
    gather,
    group,
    interpolate_features,
    query_and_group_edge,
    three_interpolate,
    three_nn,
)
from .chamfer import chamfer_sqdists, chamfer_l1, chamfer_l2, chamfer_l2_split
from .emd import auction_emd

__all__ = [
    "pairwise_sqdist",
    "farthest_point_sample",
    "knn",
    "dilated_knn",
    "topk_extract",
    "topk_extract_chunked",
    "topk_extract_pair",
    "topk_extract_price",
    "gather",
    "group",
    "three_nn",
    "three_interpolate",
    "interpolate_features",
    "query_and_group_edge",
    "GroupedEdgeFeatures",
    "chamfer_sqdists",
    "chamfer_l1",
    "chamfer_l2",
    "chamfer_l2_split",
    "auction_emd",
]
