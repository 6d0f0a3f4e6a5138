"""k smallest per row of a matrix: kernels K3, K4 and K6, and K5 on K3.

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
  the kernel, the per-iteration top-2 of the price-fused auction sweep;
  with ``rows`` it reads the rows of the auction's active-set tail
  through their ids (``ops/emd.py``).
- :func:`topk_extract_chunked` (K4) keeps the two-level semantics of the
  JAX function of that name; on the card it is one launch of the kernel.
- :data:`topk_extract_pair` (K5) is :func:`topk_extract`: K3's function, by K3's kernel.

The kernel (``csrc/topk.cu``) is bound by bytes on the H100: each element
is read once for one compare. S warps take a row (:func:`warps_for`
picks S), each a contiguous chunk with 16-byte loads, each lane keeping
a sorted top-k in registers; k warp-shuffle rounds merge the lanes'
lists and, for S > 1, a merge in shared memory the warps': one pass over
the matrix where the TPU kernel made k. A k past ``MAX_K`` runs in passes
of ``MAX_K`` within the one launch, each reading the row again.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import contracts
from .cuda import launch, sm_count

# the kernel's largest list: the most one pass over a row extracts
MAX_K = 32
# warps per row (S) the kernel is instantiated for, and the target of
# :func:`warps_for`
WARPS = (1, 2, 4, 8)
_WARPS_PER_SM = 16     # resident warps per SM that keep enough loads in flight
_MIN_CHUNK = 512       # columns per warp at the least

# kernel launches so far, one count per wrapper, added where the kernel is
# launched; chip_smoke.py resets and reads them. ``chunked_launches``
# counts K4's launches (one per call), which ``launches`` leaves out.
launches = 0
price_launches = 0
chunked_launches = 0


def warps_for(rows: int, n: int, sms: int) -> int:
    """Warps per row (S) for ``rows`` rows of ``n`` columns on a card of
    ``sms`` SMs: one, doubled while the card holds fewer than
    ``_WARPS_PER_SM`` warps per SM and each warp keeps a chunk of
    ``_MIN_CHUNK`` columns or more.

    On an H100 this picks 4 for the auction's active-set tail (1024 rows of
    4096), 2 for K4's 2048 rows of 16384 (b=4, n=16384) and 1 for K4's
    4096 rows of 8192, the full price-fused sweep and K3's matrices, the
    fastest or within 2% of it at each (PERF.md).
    """
    s = 1
    while s < WARPS[-1] and rows * s < _WARPS_PER_SM * sms and n >= _MIN_CHUNK * 2 * s:
        s *= 2
    return s


def _warps(rows: int, n: int, device: torch.device, warps: Optional[int]) -> int:
    if warps is None:
        return warps_for(rows, n, sm_count(device))
    if warps not in WARPS:
        raise ValueError(f"warps={warps}: the CUDA top-k kernel is built for {WARPS} warps per row")
    return warps


def _check(dist: torch.Tensor, k: int) -> str:
    if dist.dim() != 3:
        raise ValueError(f"dist: expected (B, M, N), got {tuple(dist.shape)}")
    contracts.check_k(k, dist.shape[-1])
    return contracts.check_device(dist, "dist")


def topk_extract(dist: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of ``(b, m, n)`` -> ``(idx int32, val f32)``, each
    ``(b, m, k)``, ascending, lowest index on ties. Values must lie below
    1e30, the mask value of extracted columns.

    A CPU tensor runs the plain torch version, a CUDA tensor the kernel.
    """
    if _check(dist, k) == "cuda":
        return _topk_extract_cuda(dist, k)
    return _topk_extract_torch(dist, k)


def _topk_extract_cuda(
    dist: torch.Tensor, k: int, warps: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the card: one launch of the kernel, counted under ``launches``."""
    return _launch_topk(dist, k, warps, "launches")


def _launch_topk(
    dist: torch.Tensor, k: int, warps: Optional[int], counter: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on ``dist``, counted under ``counter``."""
    dist = dist.to(torch.float32).contiguous()
    b, m, n = dist.shape
    s = _warps(b * m, n, dist.device, warps)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dist.device)
    val = torch.empty((b, m, k), dtype=torch.float32, device=dist.device)
    if b * m:
        launch("topk", "pan_topk_extract", dist.device, dist, idx, val, b * m, n, k, s)
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
    neg_base: torch.Tensor, price: torch.Tensor, k: int, rows: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of ``neg_base + price[:, None, :]`` (kernel K6).

    ``neg_base``: ``(b, m, n)``, the auction's iteration-invariant term;
    ``price``: ``(b, n)``, a per-column offset. Returns ``(idx int32, val
    f32)``, each ``(b, m, k)``, with :func:`topk_extract`'s order and
    tie-break, bit-equal to extracting from the materialised sum: the
    kernel performs the same f32 add per element, in registers, so the
    ``(b, m, n)`` sum is never written.

    ``rows``: optional ``(b, r)`` int64 row ids in ``[0, m]``; then output
    row ``j`` of batch element ``e``, of ``(b, r, k)``, is the extraction
    of row ``rows[e, j]`` clamped into ``[0, m - 1]`` (``m`` is the
    padding sentinel of the auction's active set), read by the kernel
    through the ids with no gathered copy.
    """
    kind = _check(neg_base, k)
    b, m, n = neg_base.shape
    if tuple(price.shape) != (b, n):
        raise ValueError(f"price: expected {(b, n)}, got {tuple(price.shape)}")
    if price.device != neg_base.device:
        raise ValueError(f"price on {price.device}, neg_base on {neg_base.device}")
    if rows is not None:
        if rows.dim() != 2 or rows.shape[0] != b or rows.dtype != torch.int64:
            raise ValueError(f"rows: expected (b={b}, r) int64, got {tuple(rows.shape)} {rows.dtype}")
        if rows.device != neg_base.device:
            raise ValueError(f"rows on {rows.device}, neg_base on {neg_base.device}")
    if kind == "cuda":
        return _topk_extract_price_cuda(neg_base, price, k, rows)
    return _topk_extract_price_torch(neg_base, price, k, rows)


def _topk_extract_price_cuda(
    neg_base: torch.Tensor,
    price: torch.Tensor,
    k: int,
    rows: Optional[torch.Tensor] = None,
    warps: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    global price_launches
    neg_base = neg_base.to(torch.float32).contiguous()
    price = price.to(torch.float32).contiguous()
    b, m, n = neg_base.shape
    r = m if rows is None else rows.shape[1]
    s = _warps(b * r, n, neg_base.device, warps)
    idx = torch.empty((b, r, k), dtype=torch.int32, device=neg_base.device)
    val = torch.empty((b, r, k), dtype=torch.float32, device=neg_base.device)
    if b * r == 0:
        return idx, val
    if rows is None:
        launch("topk", "pan_topk_extract_price", neg_base.device, neg_base, price, idx, val,
               b * m, m, n, k, s)
        price_launches += 1
    else:
        if rows.stride(1) != 1:
            rows = rows.contiguous()
        launch("topk", "pan_topk_extract_price_rows", neg_base.device, neg_base, price, rows,
               rows.stride(0), idx, val, b * r, r, m, n, k, s)
        price_launches += 1
    return idx, val


def _topk_extract_price_torch(
    neg_base: torch.Tensor, price: torch.Tensor, k: int, rows: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: gather the rows (each id clamped into ``[0, m - 1]``,
    the sentinel ``m`` to the last row), materialise the f32 sum, then
    :func:`_topk_extract_torch`."""
    if rows is not None:
        batch = torch.arange(neg_base.shape[0], device=neg_base.device)[:, None]
        neg_base = neg_base[batch, rows.clamp(0, neg_base.shape[1] - 1)]
    return _topk_extract_torch(neg_base.to(torch.float32) + price.to(torch.float32)[:, None, :], k)


def topk_extract_chunked(
    dist: torch.Tensor, k: int, num_chunks: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level exact k smallest per row (K4): the k smallest of each of
    ``num_chunks`` column chunks, then the k smallest of the ``num_chunks
    * k`` survivors.

    The JAX package takes it where a row is too wide for the TPU kernel's
    flat VMEM tile. The result equals :func:`topk_extract`'s: the top-k of
    a union of per-chunk top-ks is the global top-k, and chunk-major
    candidate order keeps the lowest global index on ties. ``num_chunks``
    defaults to the divisor of ``n`` nearest below ``sqrt(n / k)``; a chunk
    count of 1, one that does not divide ``n`` or chunks narrower than
    ``k`` fall back to the flat extraction, as in the JAX function. On the
    card the two levels are one launch of the kernel, whose S warps per
    row (:func:`warps_for`, not ``num_chunks``) are the first level and
    whose merge in shared memory is the second.
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
        return _topk_extract_chunked_cuda(dist, k)
    return _topk_extract_chunked_torch(dist, k, num_chunks)


def _topk_extract_chunked_cuda(
    dist: torch.Tensor, k: int, warps: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on the card: one launch of the kernel, counted under
    ``chunked_launches``; the chunk count does not enter it."""
    return _launch_topk(dist, k, warps, "chunked_launches")


def _topk_extract_chunked_torch(dist, k, c):
    """Plain version: the two levels of the JAX function on
    :func:`_topk_extract_torch`."""
    b, m, n = dist.shape
    sub = n // c
    li, lv = _topk_extract_torch(dist.reshape(b, m * c, sub), k)    # chunk-major rows
    offsets = torch.arange(c, dtype=torch.int32, device=dist.device)[:, None] * sub
    cand_idx = (li.reshape(b, m, c, k) + offsets).reshape(b, m, c * k)
    mi, mv = _topk_extract_torch(lv.reshape(b, m, c * k), k)
    return torch.gather(cand_idx, -1, mi.long()), mv


# Counterpart of ``topk_extract_pair_pallas`` (K5): the same function as
# :func:`topk_extract`, by the same kernel. The TPU kernel unrolls two
# extractions per pass so that its (qb, n) VMEM tile is read and written
# once per two neighbours instead of once per neighbour; K3 streams each row
# once into registers and never makes that round trip, so the pairing has
# nothing left to save here.
topk_extract_pair = topk_extract
