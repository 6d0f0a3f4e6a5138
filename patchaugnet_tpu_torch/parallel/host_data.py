"""Per-rank input feeding.

Port of ``patchaugnet_tpu/parallel/host_data.py``. In the JAX package a
host loads only the rows of the global batch that its own devices take
and contributes them to one global array. Here a process is a rank with
one device, and a global batch is held as each rank's rows: every rank
draws the same tuple batch from the same seed, and
:func:`make_global_batch` puts only this rank's rows on its device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["host_batch_slice", "host_record_indices", "make_global_batch"]


def host_batch_slice(
    global_batch: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> slice:
    """The contiguous rows of the global batch this process loads (the
    process group's rank and size by default; one process without a
    group)."""
    grouped = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if grouped else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if grouped else 1) if process_count is None else process_count
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} must split evenly over {pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def host_record_indices(
    indices: Sequence[int],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> list:
    """The subset of a global batch's record indices this process loads."""
    return list(indices[host_batch_slice(len(indices), process_index, process_count)])


def make_global_batch(mesh: Mesh, local_rows, axis_name: str = "data") -> torch.Tensor:
    """The global batch as this rank holds it: ``local_rows``, which must
    be this rank's rows (:func:`host_batch_slice`, the whole batch on a
    mesh of one), on its device. Equal to ``shard_batch(mesh, batch)``."""
    rows = local_rows if isinstance(local_rows, torch.Tensor) else torch.as_tensor(np.asarray(local_rows))
    return rows.to(mesh.device)
