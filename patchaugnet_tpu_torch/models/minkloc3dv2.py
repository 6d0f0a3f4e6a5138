"""MinkLoc3Dv2: a sparse-convolution FPN over voxels, GeM pooled.

Port of ``patchaugnet_tpu/models/minkloc3dv2.py`` (the dense-grid branch
and the blocks both branches share) and of the model half of
``patchaugnet_tpu/models/minkloc_sparse.py``. The reference builds it on
MinkowskiEngine (Minkloc3D_V2/models/minkloc.py:12-39, minkfpn.py:9-93):
conv0 (k=5) -> ``len(layers)`` stride-2 levels of residual blocks ->
``num_top_down`` transposed-conv steps with 1x1 lateral adds -> a global
pooling over the stored voxels.

One FPN (:class:`MinkFPN`) runs on either geometry:
  - **sparse** (the default, ``backend: sparse``): voxel tables at the
    configured ``quantization_step`` (the reference's 0.01, with no
    grid cap), gather convolutions over the kernel maps of
    ``minkloc_sparse.build_pyramid``; features ``(B, V, C)``;
  - **dense** (``backend: dense`` or a ``grid_size``): an occupancy grid
    of ``G^3`` cells, ``conv3d`` / ``conv_transpose3d`` (cuDNN on the
    card), features channels-last ``(B, G, G, G, C)``. Every conv output
    is zeroed outside its level's mask and the BatchNorm statistics
    cover the occupied cells only, so at the stored sites it computes
    what the sparse branch computes: it is the equivalence oracle.

Both geometries take the same parameters: every conv holds a raw
``kernel`` of the dense shape ``(k, k, k, Cin, Cout)``, the JAX leaf as it
is, so ``compat.load_jax_variables`` fills either backend from one tree
(``backbone/{conv0, down{i}, block{i}_{j}/{conv1, conv2, eca, downsample},
lateral{i}, tconv{i}}``, ``pooling/{p | net_vlad}``). The dense conv
feeds torch the kernel transposed to ``(Cout, Cin, k, k, k)``, and the
transposed conv feeds it flipped on the three spatial axes (flax's
``ConvTranspose`` puts ``K[1 - q]`` at output ``2p + q``).

``COMPUTE_DTYPE`` (``"bfloat16"``) runs the trunk at that dtype, as the
JAX package does: every conv's operands are cast to it and its products
accumulate in f32 (cuDNN's ``conv3d`` on the dense grid, the im2col
product on the tables); the masked BatchNorm and ECA's channel means run
in f32 and return the feature dtype; the quantization, the tables and the
kernel maps are the f32 path's; pooling and the descriptor are f32. The
dense trunk starts at conv0 (the occupancy grid cast to the dtype), the
sparse one after conv0, whose gather-free occupancy product stays f32, as
in ``minkloc_sparse.py`` of the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import BN_EPS, BatchNorm, compute_dtype, l2_normalize
from ..nn.vlad import NetVLADLoupe
from . import minkloc_sparse as ms


# ------------------------------------------------------------ voxelize
def cartesian_voxelize(points: torch.Tensor, grid_size: int,
                       extent: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, N, 3)`` points in ``[-extent, extent]`` onto an occupancy grid:
    ``(grid (B, G, G, G, 1), mask (B, G, G, G) bool)``."""
    g = grid_size
    scale = torch.reciprocal(torch.tensor(2 * extent, dtype=torch.float32)).to(points.device)
    ijk = torch.floor((points + extent) * scale * g).to(torch.int32).clamp(0, g - 1)
    return _occupancy(ijk, (g, g, g))


def polar_voxelize(points: torch.Tensor, grid_shape: Tuple[int, int, int], max_dist: float = 1.0,
                   z_extent: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polar quantization (theta, ring, z) onto a dense grid
    (misc/quantization.py:14-38 on fixed bins)."""
    recip = lambda c: torch.reciprocal(torch.tensor(c, dtype=torch.float32)).to(points.device)
    theta = torch.atan2(points[..., 1], points[..., 0]) * recip(2 * math.pi) + 0.5
    dist = torch.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2) * recip(max_dist)
    z = (points[..., 2] + z_extent) * recip(2 * z_extent)
    ijk = torch.stack([(a * n).to(torch.int32).clamp(0, n - 1)
                       for a, n in zip((theta, dist, z), grid_shape)], dim=-1)
    return _occupancy(ijk, tuple(grid_shape))


def _occupancy(ijk: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    b = ijk.shape[0]
    occ = torch.zeros(b, shape[0] * shape[1] * shape[2], device=ijk.device)
    occ.scatter_(1, ms.compose_keys(ijk, shape).long(), 1.0)
    grid = occ.reshape(b, *shape, 1)
    return grid, grid[..., 0] > 0


def dense_masks(mask: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Each level's occupancy: the stride-2 max-pool of the one above
    (Minkowski's downsampled coordinate map)."""
    masks = [mask]
    for _ in range(num_levels):
        masks.append(F.max_pool3d(masks[-1][:, None].float(), 2, 2)[:, 0] > 0)
    return masks


# ------------------------------------------------------------- blocks
class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the occupied sites only, the Minkowski BN
    (``minkloc3dv2.py:104-150`` of the JAX package), on ``x (..., C)``
    with ``mask`` of its leading shape. Train mode: the mean, then the
    biased variance as a second pass, over every stored site of the batch
    (count clamped to 1); ``running = 0.9 running + 0.1 batch``. Output
    ``((x - mean) * rsqrt(var + eps) * scale + bias) * mask``, zero at
    empty sites, computed in f32 and returned at ``x``'s dtype.
    (Parameter names are :class:`BatchNorm`'s, so the converter and the
    initialisers take it as one.)"""

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mf = mask[..., None].to(torch.float32)
        if self.training:
            red = tuple(range(x.dim() - 1))
            cnt = mf.sum().clamp_min(1.0)
            mean = (xf * mf).sum(red) / cnt
            var = ((xf - mean) ** 2 * mf).sum(red) / cnt
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return (((xf - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias) * mf).to(x.dtype)


class VoxelConv(nn.Module):
    """Bias-free voxel convolution, ``kernel (k, k, k, Cin, Cout)``.

    On a dense grid ``(B, G, G, G, Cin)``: ``conv3d`` with flax's SAME
    padding at ``stride``. On a table ``(B, V, Cin)``: the gather
    convolution over ``src`` (``minkloc_sparse.sparse_conv``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(kernel, kernel, kernel, cin, cout))
        self.init_fan = {"kernel": kernel ** 3 * cin}

    def forward(self, x: torch.Tensor, src: Optional[torch.Tensor] = None,
                feats_are_mask: bool = False) -> torch.Tensor:
        if x.dim() == 3:
            return ms.sparse_conv(x, self.kernel, src, feats_are_mask)
        w = self.kernel.to(x.dtype)
        k, s = w.shape[0], self.stride
        if k == 1:
            return x @ w.reshape(w.shape[3], -1)
        pads = []
        for n in reversed(x.shape[1:4]):                  # F.pad takes the last axis first
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv3d(F.pad(x.permute(0, 4, 1, 2, 3), pads), w.permute(4, 3, 0, 1, 2), stride=s)
        return y.permute(0, 2, 3, 4, 1)


class VoxelTConv(nn.Module):
    """Bias-free transposed conv, k=2 s=2, ``kernel (2, 2, 2, Cin, Cout)``:
    fine site ``2p + q`` takes ``K[1 - q] @ coarse[p]``. Dense:
    ``conv_transpose3d`` with the kernel flipped; sparse: the up map of
    ``minkloc_sparse.upsample_from_ranks``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(2, 2, 2, cin, cout))
        self.init_fan = {"kernel": 8 * cin}

    def forward(self, x: torch.Tensor, up=None) -> torch.Tensor:
        if x.dim() == 3:
            return ms.sparse_tconv(x, self.kernel, *up)
        w = self.kernel.to(x.dtype).flip(0, 1, 2).permute(3, 4, 0, 1, 2)
        return F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w, stride=2).permute(0, 2, 3, 4, 1)


class ConvBN(nn.Module):
    """Conv + masked BN; the output lives on ``out_mask``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = VoxelConv(cin, cout, kernel, stride)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, x, src, out_mask, feats_are_mask: bool = False):
        return self.bn(self.conv(x, src, feats_are_mask), out_mask)


class ECAConv(nn.Module):
    """ECA's 1-d conv across channels, ``kernel (k, 1, 1)``, SAME, no bias."""

    def __init__(self, k: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, 1, 1))
        self.init_fan = {"kernel": k}

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[0]
        return F.conv1d(y[:, None], self.kernel.reshape(1, 1, k), padding=k // 2)[:, 0]


class ECALayer(nn.Module):
    """Efficient channel attention (eca_block.py:12-35): the channel means
    over the occupied sites, a 1-d conv across channels (kernel 3 at 32
    and 64 channels, 5 at 128), a sigmoid gate. The means, the conv and
    the gate are f32; the gate is cast to ``x``'s dtype."""

    def __init__(self, channels: int, gamma: int = 2, b: int = 1):
        super().__init__()
        t = int(abs((math.log2(channels) + b) / gamma))
        self.conv = ECAConv(t if t % 2 else t + 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        red = tuple(range(1, x.dim() - 1))
        m = mask[..., None].to(torch.float32)
        y = (x.to(torch.float32) * m).sum(red) / m.sum(red).clamp_min(1.0)             # (B, C)
        gate = torch.sigmoid(self.conv(y)).to(x.dtype)
        return x * gate.reshape(gate.shape[0], *([1] * (x.dim() - 2)), -1)


class BasicBlock(nn.Module):
    """Residual block (the Minkowski BasicBlock); ``use_eca`` gates after
    the second norm (ECABasicBlock, eca_block.py:38-72)."""

    def __init__(self, cin: int, planes: int, use_eca: bool = False):
        super().__init__()
        self.width = planes
        self.conv1 = ConvBN(cin, planes)
        self.conv2 = ConvBN(planes, planes)
        self.eca = ECALayer(planes) if use_eca else None
        self.downsample = ConvBN(cin, planes, kernel=1) if cin != planes else None

    def forward(self, x, src, mask):
        out = self.conv2(torch.relu(self.conv1(x, src, mask)), src, mask)
        if self.eca is not None:
            out = self.eca(out, mask)
        residual = x if self.downsample is None else self.downsample(x, None, mask)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3x3 -> 1x1 to ``planes * expansion`` channels."""

    def __init__(self, cin: int, planes: int, expansion: int = 4):
        super().__init__()
        self.width = planes * expansion
        self.conv1 = ConvBN(cin, planes, kernel=1)
        self.conv2 = ConvBN(planes, planes)
        self.conv3 = ConvBN(planes, self.width, kernel=1)
        self.downsample = ConvBN(cin, self.width, kernel=1) if cin != self.width else None

    def forward(self, x, src, mask):
        out = torch.relu(self.conv1(x, None, mask))
        out = torch.relu(self.conv2(out, src, mask))
        out = self.conv3(out, None, mask)
        residual = x if self.downsample is None else self.downsample(x, None, mask)
        return torch.relu(out + residual)


# ---------------------------------------------------------------- FPN
class MinkFPN(nn.Module):
    """MinkFPN's topology (minkfpn.py:9-93) on either geometry.

    ``forward(x, masks, pyramid=None)``: ``masks`` are the levels'
    occupancies (dense grids or table masks). Dense: ``x`` is the
    occupancy grid ``(B, G, G, G, 1)`` and ``pyramid`` None. Sparse:
    ``pyramid`` is ``minkloc_sparse.build_pyramid``'s, and ``x`` None
    (the occupancy indicator, conv0's gather-free path) or level-0
    features ``(B, V, Cin)``. Returns the top-down output and its mask,
    at the compute ``dtype`` (None: f32): the dense trunk casts its input
    to it before conv0, the sparse one conv0's output.
    """

    def __init__(self, out_channels: int, planes: Sequence[int] = (32, 64, 64), layers: Sequence[int] = (1, 1, 1),
                 num_top_down: int = 1, conv0_kernel_size: int = 5, block: str = "ECABasicBlock", in_channels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.num_bottom_up, self.num_top_down, self.layers = len(layers), num_top_down, tuple(layers)
        self.conv0 = ConvBN(in_channels, planes[0], kernel=conv0_kernel_size)
        c = planes[0]
        fm_widths = [c] if num_top_down == self.num_bottom_up else []
        for ndx, (plane, n_layers) in enumerate(zip(planes, layers)):
            # the stride-2 conv keeps the width, the blocks change it (minkfpn.py:44-47, 75-82)
            setattr(self, f"down{ndx}", ConvBN(c, c, kernel=2, stride=2))
            for li in range(n_layers):
                blk = (Bottleneck(c, plane) if block == "Bottleneck"
                       else BasicBlock(c, plane, use_eca=block == "ECABasicBlock"))
                setattr(self, f"block{ndx}_{li}", blk)
                c = blk.width
            if self.num_bottom_up - 1 - num_top_down <= ndx < self.num_bottom_up - 1:
                fm_widths.append(c)
        # bias-free like MinkowskiConvolution (minkfpn.py:49-62)
        self.lateral0 = VoxelConv(c, out_channels, kernel=1)
        for ndx in range(num_top_down):
            setattr(self, f"tconv{ndx}", VoxelTConv(out_channels, out_channels))
            setattr(self, f"lateral{ndx + 1}", VoxelConv(fm_widths[-ndx - 1], out_channels, kernel=1))

    def forward(self, x, masks, pyramid: Optional[ms.Pyramid] = None):
        maps = lambda name, i: None if pyramid is None else getattr(pyramid, name)[i]
        feats_are_mask = x is None
        if feats_are_mask:
            x = masks[0][..., None].float()
        dt = self.compute_dtype
        if dt is not None and pyramid is None:
            x = x.to(dt)
        x = torch.relu(self.conv0(x, None if pyramid is None else pyramid.conv0_routes, masks[0], feats_are_mask))
        if dt is not None:
            x = x.to(dt)
        feature_maps = [x] if self.num_top_down == self.num_bottom_up else []
        for ndx, n_layers in enumerate(self.layers):
            x = torch.relu(getattr(self, f"down{ndx}")(x, maps("down_routes", ndx), masks[ndx + 1]))
            for li in range(n_layers):
                x = getattr(self, f"block{ndx}_{li}")(x, maps("block_routes", ndx), masks[ndx + 1])
            if self.num_bottom_up - 1 - self.num_top_down <= ndx < self.num_bottom_up - 1:
                feature_maps.append(x)
        level = self.num_bottom_up
        m = lambda lvl: masks[lvl][..., None].to(x.dtype)
        x = self.lateral0(x) * m(level)
        for ndx in range(self.num_top_down):
            level -= 1
            # upsample, keep the fine level's stored sites, add the lateral
            x = getattr(self, f"tconv{ndx}")(x, maps("up_nbr", ndx)) * m(level)
            x = x + getattr(self, f"lateral{ndx + 1}")(feature_maps[-ndx - 1]) * m(level)
        return x, masks[self.num_bottom_up - self.num_top_down]


# ------------------------------------------------------------ pooling
class MaskedPooling(nn.Module):
    """MAC / SPoC / GeM / netvlad(gc) over the occupied sites
    (layers/pooling.py:11-85)."""

    def __init__(self, pool_method: str, in_dim: int, output_dim: int):
        super().__init__()
        if pool_method not in ("MAC", "SPoC", "GeM", "netvlad", "netvladgc"):
            raise NotImplementedError(pool_method)
        self.pool_method = pool_method
        if pool_method == "GeM":
            self.p = nn.Parameter(torch.full((1,), 3.0))
            self.init_value = {"p": 3.0}
        elif pool_method in ("netvlad", "netvladgc"):
            self.net_vlad = NetVLADLoupe(in_dim, 64, output_dim, gating=pool_method == "netvladgc")

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        feats = x.reshape(b, -1, x.shape[-1])                        # (B, V, C)
        m = mask.reshape(b, -1, 1).to(x.dtype)
        count = m.sum(dim=1).clamp_min(1.0)
        if self.pool_method == "MAC":
            out = torch.where(m > 0, feats, -math.inf).amax(dim=1)
            return torch.where(torch.isfinite(out), out, 0.0)      # an empty cloud pools to 0
        if self.pool_method == "SPoC":
            return (feats * m).sum(dim=1) / count
        if self.pool_method == "GeM":
            pooled = (feats.clamp_min(1e-6) ** self.p * m).sum(dim=1) / count
            return pooled ** (1.0 / self.p)
        return self.net_vlad(feats * m)       # zero rows at empty sites, as the reference pads


# -------------------------------------------------------------- model
class MinkLoc3Dv2(nn.Module):
    """``(B, N, 3) -> (B, output_dim)`` global descriptor, on the sparse
    voxel tables (``backend="sparse"``) or the dense grid
    (``backend="dense"``, ``grid_size`` cells per axis for cartesian
    coordinates, ``polar_grid`` for polar ones), its trunk at the
    ``compute_dtype`` (None: f32), the descriptor f32."""

    def __init__(self, backend: str = "sparse", feature_size: int = 256, output_dim: int = 256,
                 planes: Sequence[int] = (64, 128, 64, 32), layers: Sequence[int] = (1, 1, 1, 1),
                 num_top_down: int = 2, conv0_kernel_size: int = 5, block: str = "ECABasicBlock",
                 pooling: str = "GeM", coordinates: str = "cartesian", quantization_step: Any = 0.01,
                 extent: float = 1.0, polar_max_dist: float = 1.5, level_capacity: Optional[Sequence[int]] = None,
                 grid_size: int = 48, polar_grid: Tuple[int, int, int] = (64, 32, 16),
                 normalize_embeddings: bool = False, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if backend not in ("sparse", "dense"):
            raise ValueError(f"backend: 'sparse' or 'dense', got {backend!r}")
        self.backend, self.coordinates, self.normalize_embeddings = backend, coordinates, normalize_embeddings
        self.quantization_step, self.extent, self.polar_max_dist = quantization_step, extent, polar_max_dist
        self.level_capacity = None if level_capacity is None else tuple(int(c) for c in level_capacity)
        self.conv0_kernel_size = conv0_kernel_size
        self.grid_dims = (grid_size,) * 3 if coordinates == "cartesian" else tuple(polar_grid)
        factor = 2 ** len(layers)
        if backend == "dense" and any(d % factor for d in self.grid_dims):
            raise ValueError(f"grid dims {self.grid_dims} must divide by 2^len(layers)={factor} for the FPN")
        self.backbone = MinkFPN(feature_size, planes, layers, num_top_down, conv0_kernel_size, block,
                                dtype=compute_dtype)
        self.pooling = MaskedPooling(pooling, feature_size, output_dim)

    def quantize(self, points: torch.Tensor):
        """The sparse backend's ``(coords (B, N, 3) int32, valid, dims)``."""
        return ms.quantize(points, self.coordinates, self.quantization_step, self.extent, self.polar_max_dist)

    def pyramid(self, points: torch.Tensor) -> ms.Pyramid:
        """The sparse backend's tables and kernel maps for ``points``."""
        coords, valid, dims = self.quantize(points)
        return ms.build_pyramid(coords, valid, dims, num_levels=self.backbone.num_bottom_up,
                                num_top_down=self.backbone.num_top_down, conv0_kernel_size=self.conv0_kernel_size,
                                level_capacity=self.level_capacity)

    def voxelize(self, points: torch.Tensor):
        """The dense backend's ``(grid (B, G, G, G, 1), mask)``."""
        if self.coordinates == "cartesian":
            return cartesian_voxelize(points, self.grid_dims[0])
        return polar_voxelize(points, self.grid_dims)

    def forward(self, points: torch.Tensor, return_diagnostics: bool = False):
        """``return_diagnostics`` (sparse only): also return
        ``{"capacity_overflow": ()}``, the voxels dropped by
        ``level_capacity`` at the fullest level (0 when every capacity
        held)."""
        if points.dim() == 4:
            points = points.squeeze(1)
        if self.backend == "sparse":
            pyramid = self.pyramid(points)
            x, out_mask = self.backbone(None, [t.mask for t in pyramid.tables], pyramid)
        else:
            if return_diagnostics:
                raise ValueError("return_diagnostics: the dense backend keeps no capacity")
            grid, mask = self.voxelize(points)
            x, out_mask = self.backbone(grid, dense_masks(mask, self.backbone.num_bottom_up))
        out = self.pooling(x.to(torch.float32), out_mask)
        if self.normalize_embeddings:
            out = l2_normalize(out, dim=-1)
        if return_diagnostics:
            return out, {"capacity_overflow": pyramid.overflow}
        return out


def grid_size_for_step(quantization_step: float, num_levels: int, extent: float = 1.0,
                       max_grid_size: int = 48) -> int:
    """Grid resolution of a quantization step (misc/quantization.py:40-50):
    ``ceil(2 extent / step)`` cells per axis rounded up to a multiple of
    ``2^num_levels``, capped at ``max_grid_size`` (at the cap the
    effective step is ``2 extent / max_grid_size``)."""
    factor = 2 ** num_levels
    g = math.ceil(2 * extent / quantization_step)
    g = ((g + factor - 1) // factor) * factor
    cap = (max_grid_size // factor) * factor
    if cap <= 0:
        raise ValueError(f"max_grid_size={max_grid_size} is smaller than the FPN downsampling factor "
                         f"2^{num_levels}={factor}: every level must keep at least one voxel")
    return min(g, cap)


def build_minkloc(param: Dict[str, Any]) -> MinkLoc3Dv2:
    """From a flat config dict (YAML keys or ModelParams fields), as the
    JAX ``build_minkloc``: the sparse backend by default, at the exact
    ``quantization_step``; the dense one when ``backend: dense`` is set or
    a ``grid_size`` is given (else sized by :func:`grid_size_for_step`
    under ``max_grid_size``); the trunk at ``COMPUTE_DTYPE`` (or
    ``compute_dtype``)."""
    layers = tuple(param.get("layers", (1, 1, 1, 1)))
    grid_size = param.get("grid_size")
    backend = param.get("backend") or ("dense" if grid_size is not None else "sparse")
    step = param.get("quantization_step", 0.01)
    if isinstance(step, (list, tuple)):
        step = tuple(float(s) for s in step)
    if backend == "dense" and grid_size is None:
        grid_size = grid_size_for_step(step, num_levels=len(layers), max_grid_size=param.get("max_grid_size", 48))
    return MinkLoc3Dv2(
        backend=backend,
        feature_size=param.get("feature_size", 256),
        output_dim=param.get("output_dim", 256),
        planes=tuple(param.get("planes", (64, 128, 64, 32))),
        layers=layers,
        num_top_down=param.get("num_top_down", 2),
        conv0_kernel_size=param.get("conv0_kernel_size", 5),
        block=param.get("block", "ECABasicBlock"),
        pooling=param.get("pooling", "GeM"),
        coordinates=param.get("coordinates", "cartesian"),
        quantization_step=step,
        extent=param.get("extent", 1.0),
        polar_max_dist=param.get("polar_max_dist", 1.5),
        level_capacity=param.get("level_capacity"),
        grid_size=grid_size or 48,
        normalize_embeddings=param.get("normalize_embeddings", False),
        compute_dtype=compute_dtype(param),
    )
