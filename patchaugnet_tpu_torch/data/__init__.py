"""Data engine: registry, scene dataset, tuple sampler, retrieval.

Port of ``patchaugnet_tpu/data``; it exports what the JAX package's
``data`` exports but the point-set augmentations of ``augment.py``, which
the CLIs never pass. Importing it needs neither pandas, PyYAML, protobuf
nor sklearn: pandas is imported to read a pickle that holds a DataFrame,
PyYAML to read the dataset list of ``PCR_EXTRA_DATASETS``, protobuf to
read or write a .pb overlap record.
"""
from .dataset_info import DATA_ROOT_ENV, DatasetInfo, data_root, dataset_info_dict, get_dataset_info
from .pointclouds import (
    abnormalize_batch,
    abnormalize_point_cloud,
    jitter_point_cloud,
    load_pc_file,
    load_pc_files,
    normalize_point_cloud,
    normalize_point_clouds,
    rotate_point_cloud,
    rotate_point_cloud_deg,
    synthetic_scene_clouds,
)
from .scene_dataset import QueryPosNegTuple, Records, SceneDataset
from .tuple_dataset import PlaceRecognitionDataset, TupleBatch
from .retrieval import RecallResult, hard_negatives, hard_negatives_batch, recall_precision, topk_neighbors
from .overlap import (
    OverlapEntry,
    build_correspondences,
    load_overlap_pb,
    save_overlap_pb,
    synthetic_overlaps,
)

__all__ = [
    "DatasetInfo",
    "dataset_info_dict",
    "get_dataset_info",
    "data_root",
    "DATA_ROOT_ENV",
    "load_pc_file",
    "load_pc_files",
    "normalize_point_cloud",
    "normalize_point_clouds",
    "abnormalize_point_cloud",
    "abnormalize_batch",
    "rotate_point_cloud",
    "rotate_point_cloud_deg",
    "jitter_point_cloud",
    "synthetic_scene_clouds",
    "SceneDataset",
    "Records",
    "QueryPosNegTuple",
    "PlaceRecognitionDataset",
    "TupleBatch",
    "topk_neighbors",
    "recall_precision",
    "RecallResult",
    "hard_negatives",
    "hard_negatives_batch",
    "OverlapEntry",
    "load_overlap_pb",
    "save_overlap_pb",
    "synthetic_overlaps",
    "build_correspondences",
]
