"""Utilities: meters, logging, timing, geometry, profiling, viz.

Port of ``patchaugnet_tpu/utils``: it exports every name that the JAX
package's ``utils`` exports, and :func:`trace` (``torch.profiler`` in
place of ``jax.profiler``); ``visualization`` is a module of it, which
imports matplotlib only to draw."""
from .geometry import (
    apply_transform,
    compute_overlap_ratio,
    get_overlap_indices,
    iou_2d,
    iou_3d,
    relative_rotation_error,
    relative_translation_error,
    rotation_matrix_z,
)
from .logging_util import MetricsWriter, get_logger
from .meters import AverageMeter
from .profiling import DeviceTimer, flops, parameter_count, trace
from .timestamps import timestamp2str

__all__ = ["get_logger", "MetricsWriter", "AverageMeter", "timestamp2str", "DeviceTimer", "flops",
           "parameter_count", "trace", "iou_2d", "iou_3d", "compute_overlap_ratio", "get_overlap_indices",
           "rotation_matrix_z", "apply_transform", "relative_rotation_error", "relative_translation_error"]
