"""MinkLoc3Dv2's sparse voxel-table geometry and gather convolution.

Port of ``patchaugnet_tpu/models/minkloc_sparse.py``: the reference's
MinkowskiEngine sparse convolutions (minkfpn.py:9-93) at the native
quantization step (0.01 over unit clouds, 225 cells per dimension after
the 16-aligned shift), over fixed-capacity sorted voxel tables:

  - quantize: ``floor(p * (1/step))`` (the product by the float32
    reciprocal of the float32 step, formed once: the JAX forward is
    jitted, and XLA rewrites ``p / step`` into that product), shifted
    non-negative;
  - table: flat int32 keys, sorted; duplicates re-keyed to ``SENTINEL``
    and sorted to the back. Capacity N at level 0 (N points occupy at
    most N voxels), optionally compacted per level (``level_capacity``);
  - stride-2 levels: coarse keys = unique(fine // 2), with each fine
    site's parent rank;
  - kernel maps (``src``): for every output site and kernel tap, the
    input row holding the neighbour, in dense-kernel tap order (index q
    is offset ``q - (k-1)//2`` per axis, x-major, z-minor), or the
    sentinel ``V`` (the INPUT table's width) where the neighbour is
    absent, out of the grid, or the site is padding. Each tap's
    neighbour key is found by a batched ``torch.searchsorted`` into the
    sorted keys. (The JAX package merges sort ranks and resolves z-run
    windows instead, because gathers are slow on the TPU; the tables
    are the same.);
  - convolution: ``out = im2col(feats, src) @ W`` (one row gather over
    all taps, absent neighbours reading an appended zero row), chunked
    by output rows; conv0 takes the occupancy as its input, so its
    im2col is the tap-validity indicator and it gathers nothing; a 1x1
    conv is a plain product;
  - transposed conv (k=2, s=2): each fine site takes
    ``W[1 - (f mod 2)] @ coarse[parent(f)]`` (the flipped slot, as flax
    ``nn.ConvTranspose``), zero where the parent was dropped by a level's
    capacity.

Parameter shapes are the dense kernels' ``(k, k, k, Cin, Cout)``, so the
dense and the sparse backend share one parameter layout
(``models/minkloc3dv2.py``).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.grouping import gather

SENTINEL = 2**31 - 1
# bytes of one im2col (or transposed-conv) block; larger convs run in
# chunks of output rows (the JAX package's bound)
CHUNK_BYTES = 512 * 1024 * 1024

Dims = Tuple[int, int, int]


class VoxelTable(NamedTuple):
    """Fixed-capacity sorted voxel table of one pyramid level."""

    keys: torch.Tensor   # (B, V) int32, ascending, SENTINEL-padded
    mask: torch.Tensor   # (B, V) bool: the slot holds a stored voxel


class Pyramid(NamedTuple):
    """Every table and kernel map of one forward (integers only, built
    once per input and shared by every conv on a map).

    ``overflow`` is the largest number of voxels that a ``level_capacity``
    below the true occupancy dropped at any level (0 when none did)."""

    tables: Tuple[VoxelTable, ...]              # level 0..num_levels
    dims: Tuple[Dims, ...]
    conv0_routes: torch.Tensor                  # (B, V0, k0^3), level 0
    block_routes: Tuple[torch.Tensor, ...]      # (B, Vi, 27), levels 1..
    down_routes: Tuple[torch.Tensor, ...]       # (B, Vi, 8), into levels 1..
    up_nbr: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]   # top-down steps
    overflow: torch.Tensor                      # () int32


def compose_keys(coords: torch.Tensor, dims: Dims) -> torch.Tensor:
    """Flatten integer coords ``(..., 3)`` to scalar keys (row-major)."""
    return (coords[..., 0] * dims[1] + coords[..., 1]) * dims[2] + coords[..., 2]


def decompose_keys(keys: torch.Tensor, dims: Dims) -> torch.Tensor:
    """Inverse of :func:`compose_keys` (garbage for SENTINEL slots:
    callers mask)."""
    r = keys // dims[2]
    return torch.stack([r // dims[1], r % dims[1], keys % dims[2]], dim=-1)


def _floor_div_step(x: torch.Tensor, step: float) -> torch.Tensor:
    """``floor(x / step)`` as the jitted JAX quantizers compute it: the
    product by the float32 reciprocal of the float32 step."""
    recip = torch.reciprocal(torch.tensor(step, dtype=torch.float32)).to(x.device)
    return torch.floor(x * recip).to(torch.int32)


def _clip_valid(coords: torch.Tensor, dims: Dims) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = torch.tensor(dims, dtype=torch.int32, device=coords.device)
    valid = ((coords >= 0) & (coords < hi)).all(dim=-1)
    return torch.minimum(coords.clamp_min(0), hi - 1), valid


def quantize_cartesian(
    points: torch.Tensor, step: float, extent: float = 1.0, align: int = 16
) -> Tuple[torch.Tensor, torch.Tensor, Dims]:
    """``floor(p / step)`` like ME.sparse_quantize (quantization.py:47),
    shifted non-negative by ``ceil(extent / step)`` rounded up to a
    multiple of ``align`` (so that floor-halving at every pyramid level
    groups the voxels as ME does). Returns ``(coords (B, N, 3) int32,
    valid (B, N), dims)``."""
    half = -(-math.ceil(extent / step) // align) * align
    dims = (2 * half + 1,) * 3
    coords, valid = _clip_valid(_floor_div_step(points, step) + half, dims)
    return coords, valid, dims


def quantize_polar(
    points: torch.Tensor,
    steps: Tuple[float, float, float],
    max_dist: float = 1.5,
    z_extent: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, Dims]:
    """PolarQuantizer (quantization.py:14-37): theta in degrees [0, 360],
    ring distance and z, each floored at its own step; the z shift is a
    multiple of 16, as in :func:`quantize_cartesian`."""
    theta = 180.0 + torch.atan2(points[..., 1], points[..., 0]) * (180.0 / math.pi)
    dist = torch.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2)
    zoff = -(-math.ceil(z_extent / steps[2]) // 16) * 16
    dims = (int(360.0 // steps[0]) + 1, math.ceil(max_dist / steps[1]) + 1, 2 * zoff + 1)
    coords = torch.stack([_floor_div_step(theta, steps[0]), _floor_div_step(dist, steps[1]),
                          _floor_div_step(points[..., 2], steps[2]) + zoff], dim=-1)
    coords, valid = _clip_valid(coords, dims)
    return coords, valid, dims


def quantize(points: torch.Tensor, coordinates: str, quantization_step, extent: float = 1.0,
             polar_max_dist: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor, Dims]:
    """The model's quantizer: cartesian at one step, polar at three (one
    step is taken for all three axes)."""
    if coordinates == "cartesian":
        return quantize_cartesian(points, float(quantization_step), extent)
    steps = quantization_step if isinstance(quantization_step, (tuple, list)) else (quantization_step,) * 3
    return quantize_polar(points, tuple(float(s) for s in steps), max_dist=polar_max_dist, z_extent=extent)


# ------------------------------------------------------------ tables
def _sorted_unique(keys: torch.Tensor) -> torch.Tensor:
    """Sort, re-key duplicates to SENTINEL, sort again."""
    keys = torch.sort(keys, dim=-1).values
    dup = torch.zeros_like(keys, dtype=torch.bool)
    dup[:, 1:] = keys[:, 1:] == keys[:, :-1]
    return torch.sort(torch.where(dup, SENTINEL, keys), dim=-1).values


def build_table(coords: torch.Tensor, valid: torch.Tensor, dims: Dims) -> VoxelTable:
    """Unique-compact integer coords ``(B, N, 3)`` into a sorted table of
    capacity N."""
    keys = _sorted_unique(torch.where(valid, compose_keys(coords, dims), SENTINEL))
    return VoxelTable(keys=keys, mask=keys != SENTINEL)


def downsample_with_ranks(table: VoxelTable, dims: Dims) -> Tuple[VoxelTable, Dims, torch.Tensor]:
    """Stride-2 coordinate map: coarse keys = unique(fine // 2), and each
    fine slot's coarse slot (``parent_rank``; on padding slots it is the
    coarse count less one, as in the JAX function). Returns ``(coarse,
    cdims, parent_rank (B, V) int32)``."""
    cdims = tuple((d + 1) // 2 for d in dims)
    ck = torch.where(table.mask, compose_keys(decompose_keys(table.keys, dims) // 2, cdims), SENTINEL)
    sk, order = torch.sort(ck, dim=1)
    new = sk != SENTINEL
    new[:, 1:] &= sk[:, 1:] != sk[:, :-1]
    crank = torch.cumsum(new, dim=1, dtype=torch.int32) - 1
    ckeys = torch.sort(torch.where(new, sk, SENTINEL), dim=-1).values
    parent_rank = torch.empty_like(crank).scatter_(1, order, crank)
    return VoxelTable(keys=ckeys, mask=ckeys != SENTINEL), cdims, parent_rank


def _compact_table(table: VoxelTable, capacity: Optional[int]) -> Tuple[VoxelTable, torch.Tensor]:
    """Slice a sorted table to a static capacity: padding sorts last, so
    this is a prefix; on overflow the highest keys drop. Returns ``(table,
    excess)``, ``excess`` the largest dropped count over the batch."""
    v = table.keys.shape[1]
    if capacity is None or capacity >= v:
        return table, torch.zeros((), dtype=torch.int32, device=table.keys.device)
    n = table.mask.sum(dim=1, dtype=torch.int32)
    excess = (n.max() - capacity).clamp_min(0)
    return VoxelTable(keys=table.keys[:, :capacity], mask=table.mask[:, :capacity]), excess


# ------------------------------------------------------- kernel maps
def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """``(k^3, 3)`` offsets in dense-kernel order: index q is offset
    ``q - (k-1)//2`` per axis (flax ``nn.Conv`` SAME)."""
    r = torch.arange(kernel_size, dtype=torch.int32, device=device) - (kernel_size - 1) // 2
    return torch.cartesian_prod(r, r, r)


def _route(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Each query key's slot in the sorted ``keys`` (B, V), or V where it
    is absent; SENTINEL queries are absent."""
    v = keys.shape[1]
    keys = keys.contiguous()                # a compacted table is a slice
    pos = torch.searchsorted(keys, queries, out_int32=True)
    hit = torch.gather(keys, 1, pos.clamp_max(v - 1).long()) == queries
    return torch.where(hit & (queries != SENTINEL), pos, v)


def _neighbour_src(table_keys: torch.Tensor, sites: torch.Tensor, site_mask: torch.Tensor, offsets: torch.Tensor,
                   dims: Dims) -> torch.Tensor:
    """``src (B, Vout, K)``: for each site ``(B, Vout, 3)`` and offset
    ``(K, 3)``, the slot in ``table_keys`` of the voxel at site + offset,
    or the sentinel V (out of the grid, absent, or a padding site)."""
    b, vout, _ = sites.shape
    nc = sites[:, :, None, :] + offsets
    hi = torch.tensor(dims, dtype=torch.int32, device=sites.device)
    inb = ((nc >= 0) & (nc < hi)).all(dim=-1) & site_mask[:, :, None]
    qk = torch.where(inb, compose_keys(nc, dims), SENTINEL)
    return _route(table_keys, qk.reshape(b, -1)).reshape(b, vout, -1)


def conv_routes(table: VoxelTable, dims: Dims, kernel_size: int) -> torch.Tensor:
    """Stride-1 kernel map ``(B, V, k^3)`` of a table onto itself."""
    coords = decompose_keys(table.keys, dims)
    return _neighbour_src(table.keys, coords, table.mask, kernel_offsets(kernel_size, coords.device), dims)


def down_routes(coarse: VoxelTable, cdims: Dims, fine: VoxelTable, fine_dims: Dims) -> torch.Tensor:
    """Kernel-2 stride-2 map ``(B, Vc, 8)``: each coarse site's children
    at ``2p + q`` in the fine table (rectangular on a compacted level;
    the sentinel is the fine table's width)."""
    sites = decompose_keys(coarse.keys, cdims) * 2
    offsets = kernel_offsets(2, sites.device)
    return _neighbour_src(fine.keys, sites, coarse.mask, offsets, fine_dims)


def upsample_from_ranks(parent_rank: torch.Tensor, fine: VoxelTable, fine_dims: Dims,
                        vc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transposed-conv map onto the fine table: ``(idx (B, V, 8), valid
    (B, V, 8))``, one valid slot per stored fine site, the flipped kernel
    slot ``1 - (f mod 2)``; none where the parent lies past the coarse
    capacity ``vc`` (a dropped parent: zero contribution)."""
    qflip = 1 - decompose_keys(fine.keys, fine_dims) % 2
    qi = (qflip[..., 0] * 2 + qflip[..., 1]) * 2 + qflip[..., 2]
    onehot = qi[..., None] == torch.arange(8, device=qi.device)
    valid = onehot & (fine.mask & (parent_rank < vc))[..., None]
    idx = parent_rank.clamp(0, vc - 1)[..., None].expand(valid.shape)
    return idx, valid


def build_pyramid(
    coords: torch.Tensor,
    valid: torch.Tensor,
    dims: Dims,
    num_levels: int,
    num_top_down: int,
    conv0_kernel_size: int,
    level_capacity: Optional[Sequence[int]] = None,
) -> Pyramid:
    """Every table and map of the FPN: the level tables (each compacted to
    its ``level_capacity`` entry, if given), conv0's map at level 0, the
    k=3 block maps at levels 1.., the down maps into levels 1.. and the up
    maps of the top-down steps."""
    if dims[0] * dims[1] * dims[2] >= SENTINEL:
        raise ValueError(f"grid {dims} has 2^31 - 1 cells or more: int32 voxel keys would overflow; use a "
                         "coarser quantization step")
    if level_capacity is not None and len(level_capacity) != num_levels + 1:
        raise ValueError(f"level_capacity needs {num_levels + 1} entries (level 0..{num_levels}), "
                         f"got {len(level_capacity)}")
    cap = lambda i: None if level_capacity is None else int(level_capacity[i])
    t0, overflow = _compact_table(build_table(coords, valid, dims), cap(0))
    tables: List[VoxelTable] = [t0]
    all_dims: List[Dims] = [dims]
    parent_ranks, downs = [], []
    for li in range(num_levels):
        coarse, cdims, prank = downsample_with_ranks(tables[-1], all_dims[-1])
        coarse, excess = _compact_table(coarse, cap(li + 1))
        overflow = torch.maximum(overflow, excess)
        parent_ranks.append(prank)
        downs.append(down_routes(coarse, cdims, tables[-1], all_dims[-1]))
        tables.append(coarse)
        all_dims.append(cdims)
    up_nbr = []
    for s in range(num_top_down):
        lvl = num_levels - 1 - s                 # the fine level of this step
        up_nbr.append(upsample_from_ranks(parent_ranks[lvl], tables[lvl], all_dims[lvl],
                                          tables[lvl + 1].keys.shape[1]))
    return Pyramid(
        tables=tuple(tables),
        dims=tuple(all_dims),
        conv0_routes=conv_routes(tables[0], dims, conv0_kernel_size),
        block_routes=tuple(conv_routes(tables[i], all_dims[i], 3) for i in range(1, num_levels + 1)),
        down_routes=tuple(downs),
        up_nbr=tuple(up_nbr),
        overflow=overflow,
    )


# ---------------------------------------------------------- conv core
def _row_chunks(rows: int, row_bytes: int):
    """Slices of ``rows`` output rows whose blocks stay within CHUNK_BYTES."""
    step = max(1, min(rows, CHUNK_BYTES // max(1, row_bytes)))
    return [slice(s, min(s + step, rows)) for s in range(0, rows, step)]


def sparse_conv(feats: torch.Tensor, kernel: torch.Tensor, src: Optional[torch.Tensor] = None,
                feats_are_mask: bool = False) -> torch.Tensor:
    """Gather convolution of ``feats (B, Vin, Cin)`` by ``kernel (k, k, k,
    Cin, Cout)`` over the map ``src (B, Vout, k^3)`` (None for k=1: the
    site itself). ``feats_are_mask``: the features are the occupancy
    (Cin = 1, 1.0 on every stored voxel), so the im2col is the tap
    validity ``src != Vin`` and nothing is gathered. The kernel is cast to
    the features' dtype; the products accumulate in f32 and come out at it."""
    kernel = kernel.to(feats.dtype)
    k, cin, cout = kernel.shape[0], kernel.shape[3], kernel.shape[4]
    if k == 1:
        return feats @ kernel.reshape(cin, cout)
    b, vin, _ = feats.shape
    kk = src.shape[-1]
    if feats_are_mask:
        if cin != 1:
            raise ValueError(f"the occupancy fast path takes Cin = 1, got {cin}")
        return (src != vin).to(feats.dtype) @ kernel.reshape(kk, cout)
    w = kernel.reshape(kk * cin, cout)
    padded = torch.cat([feats, feats.new_zeros(b, 1, cin)], dim=1)
    outs = []
    for rows in _row_chunks(src.shape[1], b * kk * cin * feats.element_size()):
        part = src[:, rows]
        g = gather(padded, part.reshape(b, -1)).reshape(b, part.shape[1], kk * cin)
        outs.append(g @ w)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def sparse_tconv(coarse: torch.Tensor, kernel: torch.Tensor, up_idx: torch.Tensor,
                 up_valid: torch.Tensor) -> torch.Tensor:
    """Transposed conv (k=2, s=2) onto the fine table: each fine site's
    parent row through one ``Cin -> 8 Cout`` product, the valid slot
    kept (at most one per site, so the masked sum adds zeros only), at the
    features' dtype."""
    cin, cout = kernel.shape[3], kernel.shape[4]
    w = kernel.to(coarse.dtype).reshape(8, cin, cout).permute(1, 0, 2).reshape(cin, 8 * cout)
    parent = gather(coarse, up_idx[..., 0])                  # (B, V, Cin)
    b, v, _ = parent.shape
    outs = []
    for rows in _row_chunks(v, b * 8 * cout * parent.element_size()):
        s = (parent[:, rows] @ w).reshape(b, -1, 8, cout)
        outs.append((s * up_valid[:, rows, :, None].to(s.dtype)).sum(dim=2))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ------------------------------------------------- capacity helpers
def measure_level_occupancy(points, *, num_levels: int = 4, coordinates: str = "cartesian",
                            quantization_step=0.01, extent: float = 1.0, polar_max_dist: float = 1.5) -> np.ndarray:
    """Occupied-voxel counts per pyramid level ``(B, num_levels + 1)`` of
    ``(B, N, 3)`` clouds (a numpy array runs on the CPU, a tensor on its
    device), to calibrate ``level_capacity``."""
    coords, valid, dims = quantize(torch.as_tensor(points, dtype=torch.float32), coordinates, quantization_step,
                                   extent, polar_max_dist)
    table = build_table(coords, valid, dims)
    counts = [table.mask.sum(dim=1)]
    for _ in range(num_levels):
        table, dims, _ = downsample_with_ranks(table, dims)
        counts.append(table.mask.sum(dim=1))
    return torch.stack(counts, dim=1).cpu().numpy()


def suggest_level_capacities(counts, *, margin: float = 1.25, align: int = 256, full: Optional[int] = None):
    """Static per-level capacities from measured occupancy: each level's
    largest count times ``margin``, rounded up to ``align``, capped at
    ``full`` (the uncompacted capacity, N)."""
    counts = np.asarray(counts)
    caps = []
    for lvl in range(counts.shape[1]):
        c = int(math.ceil(counts[:, lvl].max() * margin / align)) * align
        caps.append(min(c, full) if full is not None else c)
    return caps
