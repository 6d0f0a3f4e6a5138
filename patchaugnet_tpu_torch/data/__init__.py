"""Data engine: registry, scene dataset, tuple sampler, retrieval.

Port of ``patchaugnet_tpu/data``; it exports every name that the JAX
package's ``data`` exports, and ``fpfh``, ``fpfh_native``,
``fast_loader`` (the last two build the root ``csrc/`` sources with g++
at first use) and ``wire`` (the .pb overlap records' wire format) are
modules of it. Importing it needs neither pandas, PyYAML, protobuf nor
sklearn: pandas is imported to read a pickle that holds a DataFrame,
PyYAML to read the dataset list of ``PCR_EXTRA_DATASETS``; the .pb
overlap records are read and written without protobuf.
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
from .augment import (
    jitter_points,
    random_flip,
    random_rotation,
    random_translation,
    remove_random_block,
    remove_random_points,
    train_set_transform,
    train_transform,
)
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
    "jitter_points",
    "remove_random_points",
    "remove_random_block",
    "random_translation",
    "random_rotation",
    "random_flip",
    "train_transform",
    "train_set_transform",
]
