"""k smallest per row of a matrix: kernels K3 and K6, and K4/K5 on K3.

- :func:`topk_extract` (K3) replaces ``topk_extract_pallas``
  (``patchaugnet_tpu/ops/pallas/knn.py``, ``_extract_kernel`` +
  ``_extract_sweeps``): for a ``(b, m, n)`` f32 matrix, the k smallest
  values of every row in ascending order with their column indices, the
  lowest index among equal values. It is the split kNN path for points
  wider than 3, and on the EMD path the top-2 of the dense and row-chunked
  auction sweeps. (The feature-propagation levels' 3-NN,
  ``ops.grouping.three_nn``, runs on the kNN kernel and forms no matrix.)
- :func:`topk_extract_price` (K6) replaces ``topk_extract_price_pallas``
  (``_extract_price_kernel``, ``_extract_price2_kernel``): the same
  extraction over ``neg_base + price[:, None, :]`` with the add done in
  the kernel, the per-iteration top-2 of the price-fused auction sweep and
  of its active-set tail (``ops/emd.py``).
- :func:`topk_extract_chunked` (K4) keeps the two-level semantics of the
  JAX function of that name, composed of two K3 extractions.
- :data:`topk_extract_pair` (K5) is :func:`topk_extract`: K3's function, by K3's kernel.

The kernel (``csrc/topk.cu``) is bound by bytes on the H100: each element
is read once for one compare. One warp takes a row with coalesced loads,
each lane keeps a sorted top-k of its strided slice in registers, and k
warp-shuffle rounds merge the lanes' lists: one pass over the matrix where
the TPU kernel made k.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import contracts
from .cuda import launch

# largest k the kernel is instantiated for
MAX_K = 32

# kernel launches so far, one count per wrapper, added where the kernel is
# launched; chip_smoke.py resets and reads them. ``chunked_launches``
# counts the K3 kernel launches made by K4 (two per call), which
# ``launches`` then leaves out.
launches = 0
price_launches = 0
chunked_launches = 0


def _check(dist: torch.Tensor, k: int) -> str:
    if dist.dim() != 3:
        raise ValueError(f"dist: expected (B, M, N), got {tuple(dist.shape)}")
    contracts.check_k(k, dist.shape[-1])
    return contracts.check_device(dist, "dist")


def topk_extract(dist: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of ``(b, m, n)`` -> ``(idx int32, val f32)``, each
    ``(b, m, k)``, ascending, lowest index on ties. Values must lie below
    1e30, the mask value of extracted columns.

    A CUDA tensor runs the kernel; a CPU tensor the plain torch version.
    """
    if _check(dist, k) == "cuda":
        return _topk_extract_cuda(dist, k)
    return _topk_extract_torch(dist, k)


def _topk_extract_cuda(
    dist: torch.Tensor, k: int, counter: str = "launches"
) -> Tuple[torch.Tensor, torch.Tensor]:
    if k > MAX_K:
        raise ValueError(f"k={k}: the CUDA top-k kernel takes k <= {MAX_K}")
    dist = dist.to(torch.float32).contiguous()
    b, m, n = dist.shape
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dist.device)
    val = torch.empty((b, m, k), dtype=torch.float32, device=dist.device)
    if b * m == 0:
        return idx, val
    launch("topk", "pan_topk_extract", dist.device, dist, idx, val, b * m, n, k)
    globals()[counter] += 1
    return idx, val


def _topk_extract_torch(dist: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: k arg-min sweeps (``torch.argmin`` returns the first
    minimum), each extracted column masked to 1e30, as the TPU kernel
    sweeps its tile."""
    work = dist.to(torch.float32).clone()
    idxs, vals = [], []
    for _ in range(k):
        i = torch.argmin(work, dim=-1, keepdim=True)
        vals.append(torch.gather(work, -1, i))
        idxs.append(i)
        work.scatter_(-1, i, 1e30)
    return torch.cat(idxs, -1).to(torch.int32), torch.cat(vals, -1)


def topk_extract_price(
    neg_base: torch.Tensor, price: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of ``neg_base + price[:, None, :]`` (kernel K6).

    ``neg_base``: ``(b, m, n)``, the auction's iteration-invariant term;
    ``price``: ``(b, n)``, a per-column offset. Returns ``(idx int32, val
    f32)``, each ``(b, m, k)``, with :func:`topk_extract`'s order and
    tie-break, bit-equal to extracting from the materialised sum: the
    kernel performs the same f32 add per element, in registers, so the
    ``(b, m, n)`` sum is never written.
    """
    kind = _check(neg_base, k)
    b, m, n = neg_base.shape
    if tuple(price.shape) != (b, n):
        raise ValueError(f"price: expected {(b, n)}, got {tuple(price.shape)}")
    if price.device != neg_base.device:
        raise ValueError(f"price on {price.device}, neg_base on {neg_base.device}")
    if kind == "cuda":
        return _topk_extract_price_cuda(neg_base, price, k)
    return _topk_extract_price_torch(neg_base, price, k)


def _topk_extract_price_cuda(
    neg_base: torch.Tensor, price: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    global price_launches
    if k > MAX_K:
        raise ValueError(f"k={k}: the CUDA top-k kernel takes k <= {MAX_K}")
    neg_base = neg_base.to(torch.float32).contiguous()
    price = price.to(torch.float32).contiguous()
    b, m, n = neg_base.shape
    idx = torch.empty((b, m, k), dtype=torch.int32, device=neg_base.device)
    val = torch.empty((b, m, k), dtype=torch.float32, device=neg_base.device)
    if b * m == 0:
        return idx, val
    launch("topk", "pan_topk_extract_price", neg_base.device, neg_base, price, idx, val,
           b * m, m, n, k)
    price_launches += 1
    return idx, val


def _topk_extract_price_torch(
    neg_base: torch.Tensor, price: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialise the f32 sum, then :func:`_topk_extract_torch`."""
    return _topk_extract_torch(neg_base.to(torch.float32) + price.to(torch.float32)[:, None, :], k)


def topk_extract_chunked(
    dist: torch.Tensor, k: int, num_chunks: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level exact k smallest per row (K4): the k smallest of each of
    ``num_chunks`` column chunks, then the k smallest of the ``num_chunks
    * k`` survivors.

    The JAX package takes it where a row is too wide for the TPU kernel's
    flat VMEM tile; K3 streams rows of any width, so here it is two K3
    extractions and an index fix-up, the composition of the JAX function.
    The result equals :func:`topk_extract`'s: the top-k of a union of
    per-chunk top-ks is the global top-k, and chunk-major candidate order
    keeps the lowest global index on ties. ``num_chunks`` defaults to the
    divisor of ``n`` nearest below ``sqrt(n / k)``; a chunk count of 1, one
    that does not divide ``n`` or chunks narrower than ``k`` fall back to
    the flat extraction.
    """
    kind = _check(dist, k)
    b, m, n = dist.shape
    if num_chunks is None:
        num_chunks = max(int(round((n / max(k, 1)) ** 0.5)), 1)
        while num_chunks > 1 and n % num_chunks:
            num_chunks -= 1
    if num_chunks <= 1 or n % num_chunks or n // num_chunks < k:
        return topk_extract(dist, k)
    if kind == "cuda":
        return _topk_extract_chunked_cuda(dist, k, num_chunks)
    return _topk_extract_chunked_torch(dist, k, num_chunks)


def _two_level(dist, k, c, extract):
    b, m, n = dist.shape
    sub = n // c
    li, lv = extract(dist.reshape(b, m * c, sub), k)          # chunk-major rows
    offsets = torch.arange(c, dtype=torch.int32, device=dist.device)[:, None] * sub
    cand_idx = (li.reshape(b, m, c, k) + offsets).reshape(b, m, c * k)
    mi, mv = extract(lv.reshape(b, m, c * k), k)
    return torch.gather(cand_idx, -1, mi.long()), mv


def _topk_extract_chunked_cuda(dist, k, c):
    return _two_level(dist, k, c, functools.partial(_topk_extract_cuda, counter="chunked_launches"))


def _topk_extract_chunked_torch(dist, k, c):
    """Plain version: the same two levels on :func:`_topk_extract_torch`."""
    return _two_level(dist, k, c, _topk_extract_torch)


# Counterpart of ``topk_extract_pair_pallas`` (K5): the same function as
# :func:`topk_extract`, by the same kernel. The TPU kernel unrolls two
# extractions per pass so that its (qb, n) VMEM tile is read and written
# once per two neighbours instead of once per neighbour; K3 streams each row
# once into registers and never makes that round trip, so the pairing has
# nothing left to save here.
topk_extract_pair = topk_extract
