"""The parallel layer over ``torch.distributed``: data-parallel training
and sharded eval (``mesh``, ``host_data``), and point-axis sharding of
the ops, the descriptors and the train step (``sharded_ops``,
``sharded_model``, ``sharded_train``). Port of ``patchaugnet_tpu/parallel``,
with its public names; ``spawn``, ``init_process``, ``gather_rows`` and
``select_rows`` are the port's own (how ranks start, and the row
collectives the JAX package leaves to GSPMD)."""
from .mesh import (
    Mesh,
    make_mesh,
    spawn,
    init_process,
    replicated,
    batch_sharded,
    shard_batch,
    gather_rows,
    select_rows,
    build_parallel_train_step,
    build_parallel_forward,
    build_parallel_local_forward,
    pad_to_multiple,
)
from .host_data import host_batch_slice, host_record_indices, make_global_batch
from .sharded_ops import (
    sharded_knn,
    sharded_fps,
    sharded_topk_neighbors,
    sharded_gather,
    sharded_group,
    sharded_sa_level,
)
from .sharded_model import (
    sharded_fp_level,
    sharded_patchaugnet_descriptor,
    sharded_pointnetvlad_descriptor,
    sharded_pptnet_descriptor,
)
from .sharded_train import (
    build_sharded_train_step,
    sharded_patchaugnet_train_forward,
    sharded_pptnet_train_forward,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "spawn",
    "init_process",
    "replicated",
    "batch_sharded",
    "shard_batch",
    "gather_rows",
    "select_rows",
    "build_parallel_train_step",
    "build_parallel_forward",
    "build_parallel_local_forward",
    "pad_to_multiple",
    "host_batch_slice",
    "host_record_indices",
    "make_global_batch",
    "sharded_knn",
    "sharded_fps",
    "sharded_topk_neighbors",
    "sharded_gather",
    "sharded_group",
    "sharded_sa_level",
    "sharded_fp_level",
    "sharded_patchaugnet_descriptor",
    "sharded_pointnetvlad_descriptor",
    "sharded_pptnet_descriptor",
    "build_sharded_train_step",
    "sharded_patchaugnet_train_forward",
    "sharded_pptnet_train_forward",
]
