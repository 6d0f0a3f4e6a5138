"""Auction-algorithm approximate Earth Mover's Distance.

Port of ``patchaugnet_tpu/ops/emd.py``, itself a redesign of the reference
``libs/emd_module`` (emd_cuda.cu, emd_module.py:29-70): the Bid / GetMax /
Assign kernel loop runs over dense ``(b, n, n)`` value matrices, and a
scatter-max resolves column winners instead of CUDA atomicMax.

Semantics pinned to the reference kernels (emd_cuda.cu:95-215):
  - value(row, col) = 3.0 - ||xyz1_row - xyz2_col|| - price[col]
    (coordinates are expected normalised to [0, 1], hence the 3.0 offset);
  - every unassigned row bids for its best column with increment
    ``best - second_best + eps``;
  - each column accepts the highest bid, evicting any previous owner;
  - after ``iters`` rounds, still-unassigned rows are force-assigned to
    their current best column (the reference ``last=true`` pass), so the
    assignment may be non-injective if the auction did not converge;
  - ``dist`` is the per-row *squared* distance to the assigned column;
    gradients flow to ``xyz1`` only (emd.cpp backward).

The loop exits early once every row is assigned. Its four sweeps, as in
the JAX package:
  - dense: the ``(b, n, n)`` value matrix, top-2 by kernel K3;
  - row-chunked (``b * n^2`` above ``_VALUE_BUDGET``, or
    ``PCR_EMD_SWEEP=chunked``): distances recomputed per row chunk, top-2
    by K3, or by K4 where a row is wider than the TPU's flat tile;
  - price-fused: the iteration-invariant ``dist - 3.0`` base is formed
    once and kernel K6 adds the price row as it extracts the top-2;
  - active-set tail (``PCR_EMD_ACTIVE``): once every batch element has at
    most R unassigned rows, only those rows are gathered and swept.
All four give the same assignment: the same f32 values are reduced, in
other groupings. The JAX package gates the kernels on running on a TPU;
the port keeps every other condition, so CPU and card take the same
branches (plain versions on the CPU, kernels on the card).

``lax.while_loop`` becomes a Python loop with one host read per iteration
(the unassigned count, which decides both the loop condition and the
active-set switch). :data:`iterations` and :data:`unassigned` keep the
last call's iteration count and its unassigned rows at exit.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from .pairwise import pairwise_sqdist
from .topk import topk_extract, topk_extract_chunked, topk_extract_price

_NEG = -1e9
# The sizes below are the JAX package's, chosen for the TPU: the live value
# sweep (floats), the resident price-fused base (bytes), and the Pallas
# kernels' flat (query-block x n) VMEM tile (floats). They fix the same
# branches, row chunks and active-set width R as the JAX package takes;
# any R and any chunking give the same assignment.
_VALUE_BUDGET = 32 * 1024 * 1024
_BASE_BUDGET_BYTES = 2 * 1024 * 1024 * 1024
_VMEM_TILE_BUDGET = 4 * 1024 * 1024 // 4

# the last auction's iteration count and its unassigned rows at exit
# (before the force-assign pass); chip_smoke.py reads them
iterations = 0
unassigned = 0


def _pick_row_chunk(b: int, n: int) -> int:
    """Largest divisor of ``n`` whose ``(b, chunk, n)`` value sweep fits
    the budget (``1`` always divides, so the budget is always enforceable)."""
    if b * n * n <= _VALUE_BUDGET:
        return n
    for c in range(n // 2, 0, -1):
        if n % c == 0 and b * c * n <= _VALUE_BUDGET:
            return c
    return 1


def _pallas_query_block(m: int) -> Optional[int]:
    """The TPU kernels' query block for ``m`` rows: the full ``m`` up to
    256, else the largest multiple of 8 (<= 256) dividing ``m``."""
    if m <= 256:
        return m
    for qb in range(256, 7, -8):
        if m % qb == 0:
            return qb
    return None


def _price_sweep_block(n: int) -> Optional[int]:
    """Row block of the price-fused sweep, and the active-set width R: the
    largest multiple of 8 (<= 256) dividing ``n`` whose flat ``(qb, n)``
    tile fits the budget; None disables the fused path."""
    for qb in range(256, 7, -8):
        if n % qb == 0 and qb * n <= _VMEM_TILE_BUDGET:
            return qb
    return None


def _top2_desc(value: torch.Tensor, use_pallas: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two largest per row of ``(b, m, n)``, ties to the lowest index, as
    ``lax.top_k`` gives them: K3 on ``-value``, or K4 where the JAX package
    takes its chunked extraction. ``torch.topk`` leaves the order among
    ties unspecified, so it is not used."""
    m, n = value.shape[-2], value.shape[-1]
    qb = _pallas_query_block(m) if use_pallas else None
    if qb is not None and qb * n > _VMEM_TILE_BUDGET:
        idx, neg = topk_extract_chunked(-value, 2)
    else:
        idx, neg = topk_extract(-value, 2)
    return -neg, idx


def _set(a: torch.Tensor, index: torch.Tensor, src) -> torch.Tensor:
    """``a`` with ``a[b, index[b, j]] = src[b, j]``; index ``n`` is a
    sentinel that lands in a dropped column. Duplicate writers carry equal
    values or hit the sentinel."""
    b, n = a.shape
    return torch.cat([a, a.new_full((b, 1), -1)], dim=1).scatter_(1, index, src)[:, :n]


def _auction(
    xyz1: torch.Tensor,
    xyz2: torch.Tensor,
    eps: float,
    iters: int,
    row_chunk: Optional[int] = None,
    unass_floor: int = 0,
    eps_schedule: Optional[Tuple[float, ...]] = None,
) -> torch.Tensor:
    global iterations, unassigned
    b, n, _ = xyz1.shape
    dev = xyz1.device
    if row_chunk is None:
        row_chunk = _pick_row_chunk(b, n)
    elif row_chunk < n and n % row_chunk:
        raise ValueError(f"row_chunk {row_chunk} does not divide n={n}")
    chunked = row_chunk < n
    # tiny rows (patch-size EMD, n=20) and chunks under 8 rows stay off
    # the TPU kernels in the JAX package; here they take K3 all the same
    rows_per_sweep = row_chunk if chunked else n
    use_pallas = n >= 256 and rows_per_sweep >= 8
    sweep_mode = os.environ.get("PCR_EMD_SWEEP", "auto")
    fused_qb = _price_sweep_block(n)
    use_fused = (
        use_pallas
        and sweep_mode != "chunked"
        and fused_qb is not None
        and (sweep_mode == "fused" or 4 * b * n * n <= _BASE_BUDGET_BYTES)
    )

    def chunk_dist(x1c):
        return torch.sqrt(pairwise_sqdist(x1c, xyz2))

    if use_fused:
        neg_base = chunk_dist(xyz1) - 3.0                  # == -(3 - dist)

        def top2_sweep(price):
            idx, neg = topk_extract_price(neg_base, price, 2)
            return -neg, idx
    elif chunked:
        # recompute distances per row chunk, never hold the (b, n, n) values
        def top2_sweep(price):
            parts = [
                _top2_desc(3.0 - chunk_dist(x1c) - price[:, None, :], use_pallas)
                for x1c in xyz1.split(row_chunk, dim=1)
            ]
            return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)
    else:
        base = 3.0 - chunk_dist(xyz1)                      # (b, n, n)

        def top2_sweep(price):
            return _top2_desc(base - price[:, None, :], use_pallas)

    rows = torch.arange(n, device=dev).repeat(b, 1)
    batch = torch.arange(b, device=dev)[:, None]
    active_r = fused_qb if use_fused else None
    use_active = (
        use_fused
        and os.environ.get("PCR_EMD_ACTIVE", "auto") != "off"
        and active_r is not None
        and n > active_r
    )

    def settle(assignment_inv, price, best_i, inc, bidder, bidder_ok):
        """Column winners by scatter-max (Bid/GetMax), then the updated
        inverse assignment and prices; shared by both steps."""
        winner_inc = torch.full((b, n), _NEG, device=dev).scatter_reduce_(
            1, best_i, inc, "amax"
        )
        has_winner = winner_inc > _NEG / 2
        is_winner_row = bidder_ok & (inc >= winner_inc.gather(1, best_i))
        winner_row = torch.full((b, n), -1, dtype=torch.long, device=dev).scatter_reduce_(
            1, best_i, torch.where(is_winner_row, bidder, -1), "amax"
        )
        assignment_inv = torch.where(has_winner, winner_row, assignment_inv)
        price = torch.where(has_winner, price + winner_inc, price)
        return winner_row, has_winner, assignment_inv, price

    def step_full(assignment, assignment_inv, price, eps_p):
        unass = assignment < 0                             # (b, n)
        top2, top2_i = top2_sweep(price)
        best, better = top2[..., 0], top2[..., 1]
        best_i = top2_i[..., 0].long()                     # (b, n)
        inc = torch.where(unass, best - better + eps_p, _NEG)
        winner_row, has_winner, new_inv, price = settle(
            assignment_inv, price, best_i, inc, rows, unass
        )
        # evict previous owners of claimed columns, then assign winners (Assign)
        evict_rows = torch.where(has_winner & (assignment_inv >= 0), assignment_inv, n)
        assignment = _set(assignment, evict_rows, -1)
        assignment = _set(assignment, torch.where(has_winner, winner_row, n), rows)
        return assignment, new_inv, price

    def step_active(assignment, assignment_inv, price, eps_p):
        r = active_r
        unass = assignment < 0
        # compact the unassigned row ids (ascending) into R slots; padding
        # slots keep the ``n`` sentinel
        pos = torch.cumsum(unass, dim=1) - 1
        slot = torch.where(unass & (pos < r), pos, r)
        ids = _set(torch.full((b, r), n, dtype=torch.long, device=dev), slot, rows)
        valid = ids < n
        rows_g = neg_base[batch, ids.clamp_max(n - 1)]     # (b, R, n)
        idx, negv = topk_extract_price(rows_g, price, 2)
        best, better = -negv[..., 0], -negv[..., 1]
        best_i = idx[..., 0].long()                        # (b, R)
        inc = torch.where(valid, best - better + eps_p, _NEG)
        winner_row, _, new_inv, price = settle(
            assignment_inv, price, best_i, inc, ids, valid
        )
        # every valid bid wins its column, so evict/assign touch only the
        # active rows' targets
        prev_owner = assignment_inv.gather(1, best_i)
        evict_rows = torch.where(valid & (prev_owner >= 0), prev_owner, n)
        assignment = _set(assignment, evict_rows, -1)
        is_final = valid & (winner_row.gather(1, best_i) == ids)
        assignment = _set(assignment, torch.where(is_final, ids, n), best_i)
        return assignment, new_inv, price

    assignment = torch.full((b, n), -1, dtype=torch.long, device=dev)
    assignment_inv = torch.full((b, n), -1, dtype=torch.long, device=dev)
    price = torch.zeros((b, n), dtype=torch.float32, device=dev)
    floor = max(unass_floor, 0)
    i = 0
    # eps-scaling (opt-in): phases at eps * mult, coarse to fine, prices
    # carried, assignments reset, one iteration budget for all phases
    for pi, mult in enumerate(eps_schedule or (1.0,)):
        if pi:
            assignment = torch.full_like(assignment, -1)
            assignment_inv = torch.full_like(assignment_inv, -1)
        eps_p = eps * float(mult)
        while i < iters:
            most = int((assignment < 0).sum(dim=1).max())  # the one host read
            if most <= floor:
                break
            step = step_active if use_active and most <= active_r else step_full
            assignment, assignment_inv, price = step(assignment, assignment_inv, price, eps_p)
            i += 1
    iterations = i
    unassigned = int((assignment < 0).sum())
    # force-assign stragglers to their current best column (last=true pass)
    _, t2i = top2_sweep(price)
    return torch.where(assignment < 0, t2i[..., 0].long(), assignment)


class _AuctionEMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters, row_chunk, unass_floor, eps_schedule):
        assignment = _auction(
            xyz1.to(torch.float32), xyz2.to(torch.float32), eps, iters,
            row_chunk, unass_floor, eps_schedule,
        )
        matched = torch.gather(xyz2, 1, assignment[..., None].expand(-1, -1, xyz2.shape[-1]))
        dist = ((xyz1 - matched) ** 2).sum(dim=-1)
        ctx.save_for_backward(xyz1, matched)
        assignment = assignment.to(torch.int32)
        ctx.mark_non_differentiable(assignment)
        return dist, assignment

    @staticmethod
    def backward(ctx, g_dist, _g_assignment):
        xyz1, matched = ctx.saved_tensors
        # emd.cpp backward: the gradient w.r.t. xyz1 only
        g_xyz1 = 2.0 * g_dist[..., None] * (xyz1 - matched)
        return g_xyz1, torch.zeros_like(matched), None, None, None, None, None


def auction_emd(
    xyz1: torch.Tensor,
    xyz2: torch.Tensor,
    eps: float = 0.005,
    iters: int = 50,
    row_chunk: Optional[int] = None,
    unass_floor: int = 0,
    eps_schedule: Optional[Tuple[float, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate EMD between same-size clouds.

    Args:
      xyz1, xyz2: ``(b, n, 3)`` clouds normalised to ~[0, 1].
      eps: auction bid increment (the reference uses 0.02 in its losses).
      iters: max auction rounds (the reference uses 1024).
      row_chunk: value-sweep chunk size; None picks it so the live value
        matrix stays under ``_VALUE_BUDGET`` floats. An explicit chunk
        smaller than ``n`` must divide ``n`` (``ValueError`` otherwise).
      unass_floor: convergence-aware exit (0 = exact reference semantics):
        stop once every batch element has at most this many unassigned
        rows and force-assign those to their best column.
      eps_schedule: opt-in eps-scaling, descending multipliers such as
        ``(10.0, 1.0)``: each phase runs at ``eps * mult`` with prices
        carried and assignments reset, under the shared ``iters`` budget.

    Returns:
      ``(dist, assignment)``: per-point squared distances ``(b, n)`` and
      the int32 assignment of each xyz1 row to an xyz2 row.
    """
    if xyz1.shape != xyz2.shape or xyz1.dim() != 3 or xyz1.shape[-1] != 3:
        raise ValueError(
            f"auction_emd expects matching (b, n, 3) clouds, got "
            f"{tuple(xyz1.shape)} vs {tuple(xyz2.shape)}"
        )
    return _AuctionEMD.apply(
        xyz1, xyz2, eps, iters, row_chunk, unass_floor,
        tuple(eps_schedule) if eps_schedule else None,
    )
