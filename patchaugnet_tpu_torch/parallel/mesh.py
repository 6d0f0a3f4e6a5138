"""Data-parallel layer over ``torch.distributed``.

Port of ``patchaugnet_tpu/parallel/mesh.py``. The JAX package runs the
single-device program under GSPMD on a mesh: the tuple-batch axis is
sharded, the BatchNorm statistics are those of the whole batch, the patch
correspondence tables index the whole flattened batch, and the zero-loss
gate reads the global total. Here that program is one process per rank in
a ``torch.distributed`` process group, in PyTorch's idiom:

  - each rank holds its rows of the global batch (:func:`shard_batch`,
    ``host_data.make_global_batch``) and runs the model on them, its
    train-mode BatchNorms taking the whole batch's statistics
    (``nn.core.batch_stats_group``);
  - the loss is computed on every rank from the whole batch's
    descriptors and the patch branch's rows, gathered from their ranks by
    collectives that carry autograd (:func:`gather_rows`,
    :func:`select_rows`), so every rank computes the same total;
  - every rank computing the same loss, the backward gives each rank's
    parameters ``size`` times its share of the gradient: one ``all_reduce``
    of every gradient, divided by the world size, gives every rank the
    single-device gradient, and the optimizer then leaves every rank's
    parameters, moments and running statistics identical.

A :class:`Mesh` is this rank's handle on the group: its process groups
per axis, its coordinates, the world size and its device. Ranks start
with :func:`spawn` (``torch.multiprocessing``, start method ``spawn``,
rendezvous through a ``FileStore`` in a temporary directory). Backends:
NCCL where each rank has its own card; gloo on the CPU; gloo for several
ranks on one card (NCCL refuses two ranks on one device), where every
collective moves its CUDA tensors through the host, by design.
"""
from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..nn.core import batch_stats_group, group_sum
from ..serving import _eval_mode, global_desc, has_local_fields, resolve_device

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
]

_TIMEOUT = datetime.timedelta(minutes=10)
_device: Optional[torch.device] = None      # this rank's device, set by init_process


class Mesh:
    """One rank's view of a mesh of ``prod(shape)`` ranks laid out
    row-major over the named axes (the JAX mesh of
    ``np.array(devices).reshape(shape)``).

    ``shape[axis]`` is an axis' size, :meth:`index` this rank's coordinate
    along it and :meth:`group` the process group of the ranks that differ
    from this one along that axis only. ``rank``, ``size`` and ``device``
    are this rank's global rank, the world size and its device.
    """

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device, groups: Dict[str, Any]):
        self.shape, self.rank, self.device, self._groups = dict(shape), rank, device, groups
        self.size = math.prod(self.shape.values())
        self._coords = dict(zip(self.shape, np.unravel_index(rank, tuple(self.shape.values()))))

    def index(self, axis: str) -> int:
        return int(self._coords[axis])

    def group(self, axis: Optional[str] = None):
        """The process group along ``axis``; ``None``: the whole mesh."""
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def init_process(rank: int, world_size: int, store_path: str, platform: str = "gpu",
                 share_device: bool = False) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` through the
    ``FileStore`` at ``store_path``, and return this rank's device: the
    CPU (gloo), card ``rank`` (NCCL), or with ``share_device`` card ``rank``
    modulo the card count (gloo)."""
    global _device
    if platform == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        device = resolve_device(torch.device("cuda", rank % torch.cuda.device_count() if share_device else rank))
        torch.cuda.set_device(device)
        backend = "gloo" if share_device else "nccl"
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, timeout=_TIMEOUT)
    _device = device
    return device


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int, workdir: str, platform: str,
               share_device: bool) -> None:
    if platform == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_process(rank, world_size, os.path.join(workdir, "store"), platform, share_device)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, num_devices: int, args: Sequence = (), platform: str = "gpu",
          share_device: bool = False) -> List[Any]:
    """Run ``fn(*args)`` on ``num_devices`` ranks, one process each, and
    return every rank's result (CPU tensors) in rank order.

    ``fn`` must be importable by name (the start method is ``spawn``) and
    calls :func:`make_mesh` for its handle. ``platform`` ``"gpu"`` puts
    rank r on card r, and asking for more ranks than there are cards
    raises unless ``share_device`` puts them on the cards in turn, over
    gloo; ``"cpu"`` runs every rank on the CPU over gloo.
    """
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"platform={platform!r}: expected 'gpu' or 'cpu'")
    if num_devices < 1:
        raise ValueError(f"num_devices={num_devices}: expected at least 1")
    if platform == "gpu":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("CUDA is not available; pass platform='cpu' to run the ranks on the CPU")
        if num_devices > cards and not share_device:
            raise ValueError(f"requested {num_devices} devices, have {cards} CUDA device(s); pass "
                             f"share_device=True (the CLIs' --share-device) to put several ranks on one card "
                             f"(over gloo)")
    workdir = tempfile.mkdtemp(prefix="pan_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, tuple(args), num_devices, workdir, platform, share_device),
            nprocs=num_devices, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), map_location="cpu", weights_only=False)
                for r in range(num_devices)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              shape: Optional[Dict[str, int]] = None) -> Optional[Mesh]:
    """This rank's handle on a 1-D mesh ``{axis_name: num_devices}`` over
    the first ``num_devices`` ranks of the process group (``None``: all of
    them), or on the mesh of ``shape`` (axis name to size, row-major, e.g.
    ``{"data": 2, "points": 2}``). Every rank of the group calls it, in
    the same order (the sub-groups are made collectively); a rank outside
    the mesh gets ``None``. Asking for more devices than the group has
    ranks raises, as the JAX ``make_mesh`` asserts."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with parallel.spawn (or parallel.init_process)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = {axis_name: world if num_devices is None else num_devices}
    n = math.prod(shape.values())
    if n > world:
        raise ValueError(f"requested a mesh of {n} devices {shape}, the process group has {world} ranks")
    device = _device if _device is not None else torch.device("cpu")
    groups: Dict[Optional[str], Any] = {None: dist.group.WORLD if n == world else dist.new_group(list(range(n)))}
    grid = np.arange(n).reshape(tuple(shape.values()))
    for a, name in enumerate(shape):
        if len(shape) == 1:
            groups[name] = groups[None]
            break
        for line in np.moveaxis(grid, a, -1).reshape(-1, shape[name]):
            g = dist.new_group([int(r) for r in line])        # every rank makes every group, in one order
            if rank in line:
                groups[name] = g
    return Mesh(shape, rank, device, groups) if rank < n else None


def replicated(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Give every rank rank 0's parameters and buffers, in place (one
    broadcast of them flattened per dtype); returns ``module``."""
    tensors = [t.data for t in [*module.parameters(), *module.buffers()]]
    for dtype in {t.dtype for t in tensors}:
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=0, group=mesh.group())
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))
    return module


def batch_sharded(mesh: Mesh, global_rows: int, axis_name: str = "data") -> slice:
    """This rank's rows of a global batch of ``global_rows`` split evenly
    along ``axis_name``, in rank order (the JAX ``P(axis_name)``)."""
    size = mesh.shape[axis_name]
    if global_rows % size:
        raise ValueError(f"a batch of {global_rows} rows does not split evenly over {size} devices")
    per = global_rows // size
    i = mesh.index(axis_name)
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh: Mesh, arr, axis_name: str = "data") -> torch.Tensor:
    """This rank's rows of the host array ``arr`` (leading axis split
    over ``axis_name``), on this rank's device."""
    rows = arr[batch_sharded(mesh, arr.shape[0], axis_name)]
    return torch.as_tensor(np.asarray(rows) if not isinstance(rows, torch.Tensor) else rows, device=mesh.device)


def gather_rows(local: torch.Tensor, mesh: Mesh, axis_name: str = "data", dim: int = 0) -> torch.Tensor:
    """Every rank's ``local`` along ``dim``, concatenated in rank order
    along ``axis_name``: the bits each rank holds.

    Without autograd it is one ``all_gather_into_tensor``. Where ``local``
    needs a gradient, each rank puts its block at its offset, exact zeros
    elsewhere, into one sum (:func:`nn.core.group_sum`), whose backward is
    an ``all_reduce`` that gives each rank the sum of every rank's gradient
    of its block. An all-gather's backward is a ``reduce_scatter``, which
    gloo lacks; the gathers that carry a gradient are the train steps'
    descriptors, kilobytes."""
    group, size, i = mesh.group(axis_name), mesh.shape[axis_name], mesh.index(axis_name)
    if torch.is_grad_enabled() and local.requires_grad:
        shape = list(local.shape)
        blocks = []
        for count in (i, size - 1 - i):
            shape[dim] = local.shape[dim] * count
            blocks.append(local.new_zeros(shape))
        return group_sum(torch.cat([blocks[0], local, blocks[1]], dim), group)
    front = local.movedim(dim, 0).contiguous()
    out = front.new_empty((size * front.shape[0], *front.shape[1:]))
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def select_rows(local: torch.Tensor, rows: torch.Tensor, mesh: Mesh, axis_name: str = "data") -> torch.Tensor:
    """``global[rows]`` of a batch held as each rank's rows ``local``
    (``(b, ...)`` per rank): each global row comes from the rank that owns
    it, the others add exact zeros (one ``all_reduce`` over
    ``axis_name``, as the JAX ``sharded_gather`` psums), so the values are
    the owner's bits. Carries autograd."""
    b = local.shape[0]
    offset = mesh.index(axis_name) * b
    loc = rows.to(torch.int64) - offset
    owned = (loc >= 0) & (loc < b)
    picked = local[loc.clamp(0, b - 1)]
    picked = torch.where(owned.reshape((-1,) + (1,) * (local.dim() - 1)), picked, torch.zeros((), dtype=local.dtype,
                                                                                             device=local.device))
    return group_sum(picked, mesh.group(axis_name))


def all_reduce_gradients(module: nn.Module, mesh: Mesh) -> None:
    """Every parameter's gradient summed over the mesh and divided by its
    size, in one ``all_reduce`` of the flattened gradients; a parameter
    without one gets zeros first (the optimizer updates every parameter,
    ``TrainState.apply_gradients``)."""
    params = list(module.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.group())
    flat /= mesh.size
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()


def build_parallel_train_step(model: nn.Module, cfg: Dict[str, Any], mesh: Mesh,
                              axis_name: str = "data") -> Callable:
    """``step(state, clouds, corr, cloud_mask) -> (state, metrics)`` with
    the tuple-batch axis split over ``axis_name``: ``clouds`` and
    ``cloud_mask`` are this rank's rows of the flattened batch
    (:func:`shard_batch`), ``corr`` the whole batch's tables (they index
    the whole batch). ``model`` is broadcast from rank 0 here
    (:func:`replicated`) and is the model the step runs (``state.model``).

    The step is ``train.build_train_step``'s on the whole batch: this
    rank's rows through the model with the batch's BatchNorm statistics,
    the global descriptors gathered, the patch branch's rows picked by
    ``_first_true`` over the whole batch's mask (they come from any rank)
    and run through the model's patch branch on every rank, the loss, its
    backward, the gradients averaged over the mesh (see the module
    docstring: the single-device gradients), the zero-loss gate on the
    global total, and one optimizer update. Metrics are the global ones,
    the same on every rank. ``REMAT`` recomputes this rank's forward with
    the same statistics.
    """
    from ..train.step import _loss_parts, remat_apply

    if cfg.get("LOSS_FUNCTION", "").lower() == "truncatedsmoothap":
        raise ValueError("the data-parallel step trains the tuple losses; TruncatedSmoothAP (MinkLoc3Dv2) trains on "
                         "one device")
    if (cfg["model_type"] == "patch_aug_net" and cfg.get("use_patch_recon", False)
            and getattr(model, "decoder", None) is None):
        raise ValueError("use_patch_recon needs a model built with its decoder (use_a2a_recon=True)")
    use_patches, patch_rows, terms = _loss_parts(cfg)
    group = mesh.group(axis_name)
    size = mesh.shape[axis_name]
    replicated(mesh, model)
    apply = remat_apply(model, cfg, extra=lambda: batch_stats_group(group, size))

    def train_step(state, clouds, corr, cloud_mask):
        net = state.model
        net.train()
        clouds = torch.as_tensor(clouds, dtype=torch.float32, device=mesh.device)
        cloud_mask = torch.as_tensor(cloud_mask, dtype=torch.bool, device=mesh.device)
        state.optimizer.zero_grad(set_to_none=True)
        out = apply(clouds)
        desc = gather_rows(global_desc(out), mesh, axis_name)
        patch_data = sel = sel_valid = None
        if use_patches:
            sel, sel_valid = patch_rows(gather_rows(cloud_mask.to(torch.int32), mesh, axis_name).bool())
            patch_data = net._patches(
                select_rows(clouds, sel, mesh, axis_name),
                select_rows(out.center_idx_origin[0], sel, mesh, axis_name),
                select_rows(out.sample_idx_origin[0], sel, mesh, axis_name),
                select_rows(out.fp_features[1], sel, mesh, axis_name), None)
        total, metrics = terms(desc, patch_data, sel, sel_valid, corr.to(mesh.device), desc.shape[0])
        total.backward()
        all_reduce_gradients(net, mesh)
        state.apply_gradients(keep=total.detach() > 1e-10)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_parallel_forward(model: nn.Module, mesh: Mesh, axis_name: str = "data") -> Callable:
    """Sharded descriptor extraction: ``forward(clouds)`` takes this rank's
    records (:func:`shard_batch`), runs them in eval mode and returns the
    whole batch's ``(B, D)`` descriptors on every rank."""
    model.to(mesh.device)

    def forward(clouds) -> torch.Tensor:
        with _eval_mode(model):
            x = torch.as_tensor(clouds, dtype=torch.float32, device=mesh.device)
            return gather_rows(global_desc(model(x)), mesh, axis_name)

    return forward


def build_parallel_local_forward(model: nn.Module, mesh: Mesh, axis_name: str = "data") -> Optional[Callable]:
    """Sharded ``(global, local, center_idx)`` extraction, the mesh form of
    ``serving.build_local_forward_fn``: this rank's records in, the whole
    batch's three outputs out on every rank, so a descriptor store written
    from them holds the bytes of a one-device run. ``None`` for a model
    without local descriptors, as the single-device builder."""
    if not has_local_fields(model):
        return None
    model.to(mesh.device)

    def forward(clouds):
        with _eval_mode(model):
            x = torch.as_tensor(clouds, dtype=torch.float32, device=mesh.device)
            out = model(x)
            return tuple(gather_rows(t, mesh, axis_name)
                         for t in (out.global_desc, out.fp_features[-2], out.center_idx_origin[0]))

    return forward


def pad_to_multiple(arr: np.ndarray, multiple: int):
    """Pad the leading axis to a multiple (sharding needs even splits) by
    repeating the last row. Returns (padded, original_length)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.repeat(arr[-1:], rem, axis=0)
    return np.concatenate([arr, pad]), n
