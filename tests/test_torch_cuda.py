"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test asks for the ``device`` fixture, which skips
when no CUDA device is present (decided inside the fixture, so every
pytest worker collects the same tests). Run on a machine with an NVIDIA
H100: ``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` sets up JAX, which that machine need not have;
this file needs none of it). The first test to launch a kernel builds the
kernels with nvcc into ``build/``.

Indices must be exactly equal; values agree to 1e-6 (the kernels and the
plain versions round every distance the same way, so they are expected
to agree bit for bit). The top-k kernel (K3, K4 and K6, at every built
warps-per-row count) and the auction EMD that runs it are held to exact
equality.
"""
import importlib

import numpy as np
import pytest
import torch

from patchaugnet_tpu_torch import ops
from patchaugnet_tpu_torch.losses import emd_loss

pytestmark = pytest.mark.cuda

fps_ops = importlib.import_module("patchaugnet_tpu_torch.ops.fps")
knn_ops = importlib.import_module("patchaugnet_tpu_torch.ops.knn")
topk_ops = importlib.import_module("patchaugnet_tpu_torch.ops.topk")


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cloud(rng, b, n, device, ties=False):
    if ties:
        pts = rng.randint(0, 4, size=(b, n, 3)).astype(np.float32)
        pts[:, 1::7] = pts[:, 0:1]
    else:
        pts = rng.rand(b, n, 3).astype(np.float32)
    return torch.from_numpy(pts).to(device)


def _far_ties(rng, b, n, threads, device):
    """Points in [0, 0.5)^3 and, at indices in different warps and at
    different points-per-thread slots of a ``threads``-wide layout, copies
    of the farthest point (1, 1, 1): the first pick after 0 is a tie among
    them, which the lowest index must win."""
    pts = rng.rand(b, n, 3).astype(np.float32) * 0.5
    for j in (n - 1, 3 * n // 4 + 1, n // 2 + 33, threads + 5, 40, 7):
        if 0 < j < n:
            pts[:, j] = 1.0
    return torch.from_numpy(pts).to(device)


def _fps_cases():
    """(layout, b, n, m): the layout rule's pick (layout None) at the SA
    shapes, at b = 100, at the one-warp, register and scratch boundaries
    and at m > n; then every layout the kernel is built for, forced, on a
    full layout (n = threads * points per thread), one with n not a
    multiple of 32 and a small cloud with m > n (whole warps of padding)."""
    cases = [(None, b, n, m) for b, n, m in [(2, 64, 16), (3, 100, 25), (2, 1024, 128), (2, 4096, 1024),
                                             (1, 3000, 77), (1, 9000, 40), (2, 12, 20), (100, 4096, 64),
                                             (100, 128, 16)]]
    warp_n = 32 * fps_ops.WARP_MAX_PPT
    cases += [(None, 1, n, 50) for n in (warp_n, warp_n + 1, 8192, 8193)]
    for layout in fps_ops.LAYOUTS:
        full = layout[0] * layout[1] or 8193
        cases += [(layout, 2, full, min(full, 100)), (layout, 1, full - 5, 33), (layout, 2, min(full, 21), 45)]
    return cases


@pytest.mark.parametrize("layout,b,n,m", _fps_cases())
def test_fps_matches_plain(device, rng, layout, b, n, m):
    """Indices bit-equal to the plain version on random clouds, clouds on a
    coarse grid with duplicated points, ties of the farthest point across
    warps and slots, and all-equal clouds; one launch per call."""
    threads = (layout or fps_ops.layout_for(n))[0]
    for x in (_cloud(rng, b, n, device), _cloud(rng, b, n, device, ties=True),
              _far_ties(rng, b, n, threads, device), torch.ones(b, n, 3, device=device)):
        before = fps_ops.launches
        got = ops.farthest_point_sample(x, m) if layout is None else fps_ops._fps_cuda(x, m, layout=layout)
        torch.cuda.synchronize()
        assert fps_ops.launches == before + (m > 1)
        assert torch.equal(got, fps_ops._farthest_point_sample_torch(x, m))


def test_fps_rejects_what_the_kernel_does_not_take(device):
    x = torch.rand(1, 64, 3, device=device)
    for layout in ((128, 1), (256, 4), (1024, 16), (512, 0), (32, 1)):   # not built, or too small for n = 64
        with pytest.raises(ValueError):
            fps_ops._fps_cuda(x, 8, layout=layout)
    with pytest.raises(ValueError):
        fps_ops._fps_cuda(torch.rand(1, 0, 3, device=device), 8)


def test_fps_all_equal_and_ties(device, rng):
    ones = torch.ones(2, 300, 3, device=device)
    assert torch.equal(ops.farthest_point_sample(ones, 50), torch.zeros(2, 50, dtype=torch.int32, device=device))
    x = _cloud(rng, 3, 500, device, ties=True)
    assert torch.equal(ops.farthest_point_sample(x, 64), fps_ops._farthest_point_sample_torch(x, 64))


@pytest.mark.parametrize("b,n,m,k", [(2, 4096, 1024, 20), (2, 1024, 128, 20), (4, 128, 16, 20),
                                     (2, 300, 70, 3), (1, 2500, 33, 7), (1, 64, 64, 32)])
def test_knn_matches_plain(device, rng, b, n, m, k):
    x, q = _cloud(rng, b, n, device), _cloud(rng, b, m, device)
    before = knn_ops.launches
    gi, gd = ops.knn(x, q, k)
    torch.cuda.synchronize()
    assert knn_ops.launches == before + 1
    ri, rd = knn_ops._knn_torch(x, q, k)
    assert torch.equal(gi, ri)
    torch.testing.assert_close(gd, rd, atol=1e-6, rtol=0)


# (lanes, k): every lanes count the rule can pick at k = 1, 3, 20, 32 (at
# most 3 list slots per lane, ceil(k / lanes)), then 4 lanes with 2 and 3
# slots and 8 lanes with 2, the instantiations those leave out
_LANES_K = [(g, k) for k in (1, 3, 20, 32) for g in knn_ops.LANES if -(-k // g) <= knn_ops._MAX_SLOTS]
_LANES_K += [(4, 7), (4, 11), (8, 15)]


@pytest.mark.parametrize("lanes,k", _LANES_K)
@pytest.mark.parametrize("n,m", [(4099, 70), (333, 45), (37, 9)])
def test_knn_lanes_match_plain(device, rng, lanes, k, n, m):
    """Every (lanes, slots per lane) instantiation the lanes rule can pick,
    at k = 1, 3, 20, 32 where the rule allows it: n past one 2048-candidate
    tile and not a multiple of it or of the lanes, a cloud whose rows are
    not 16-byte aligned (n = 333, 37), and n < lanes * k; indices and d2
    exactly equal."""
    k = min(k, n)
    x, q = _cloud(rng, 2, n, device), _cloud(rng, 2, m, device)
    gi, gd = knn_ops._knn_cuda(x, q, k, lanes=lanes)
    ri, rd = knn_ops._knn_torch(x, q, k)
    assert torch.equal(gi, ri) and torch.equal(gd, rd)
    x, q = _cloud(rng, 2, n, device, ties=True), _cloud(rng, 2, m, device, ties=True)
    gi, gd = knn_ops._knn_cuda(x, q, k, lanes=lanes)
    ri, rd = knn_ops._knn_torch(x, q, k)
    assert torch.equal(gi, ri) and torch.equal(gd, rd)
    gi, gd = knn_ops._knn_cuda(torch.ones(2, n, 3, device=device), torch.ones(2, m, 3, device=device),
                               k, lanes=lanes)
    assert torch.equal(gi.cpu(), torch.arange(k, dtype=torch.int32).expand(2, m, k))
    assert not gd.any()


@pytest.mark.parametrize("b,n,m", [(32, 1024, 4096), (32, 128, 1024), (32, 16, 128)])
def test_three_nn_runs_knn_kernel(device, rng, b, n, m):
    """The FP levels' 3-NN: one kNN launch and no top-k launch, the indices
    and distances of the formed matrix's top-3 extraction bit for bit."""
    known, unknown = _cloud(rng, b, n, device), _cloud(rng, b, m, device)
    before = knn_ops.launches, topk_ops.launches
    dist, idx = ops.three_nn(unknown, known)
    torch.cuda.synchronize()
    assert (knn_ops.launches, topk_ops.launches) == (before[0] + 1, before[1])
    ri, rd = ops.topk_extract(ops.pairwise_sqdist(unknown, known), 3)
    assert torch.equal(idx, ri) and torch.equal(dist, torch.sqrt(rd))


def test_knn_rejects_what_the_kernel_does_not_take(device):
    x = torch.rand(1, 64, 3, device=device)
    with pytest.raises(ValueError):
        knn_ops._knn_cuda(x, x, 3, lanes=2)
    with pytest.raises(ValueError):                     # 5 list slots per lane
        knn_ops._knn_cuda(x, x, 20, lanes=4)
    with pytest.raises(ValueError):                     # 5 list slots per lane; passes take 32
        knn_ops._knn_cuda(x, x, 33, lanes=8)
    with pytest.raises(ValueError):
        knn_ops._knn_cuda(x, x, 65)
    with pytest.raises(ValueError):
        knn_ops._knn_cuda(x, x.cpu(), 3)


def test_knn_all_equal_and_ties(device, rng):
    gi, gd = ops.knn(torch.ones(2, 40, 3, device=device), torch.ones(2, 8, 3, device=device), 6)
    assert torch.equal(gi.cpu(), torch.arange(6, dtype=torch.int32).expand(2, 8, 6))
    x, q = _cloud(rng, 2, 700, device, ties=True), _cloud(rng, 2, 90, device, ties=True)
    gi, gd = ops.knn(x, q, 20)
    ri, rd = knn_ops._knn_torch(x, q, 20)
    assert torch.equal(gi, ri) and torch.equal(gd, rd)


@pytest.mark.parametrize("b,m,n,k", [(2, 4096, 1024, 3), (2, 1024, 128, 3), (2, 128, 16, 3),
                                     (1, 64, 1000, 20), (1, 50, 77, 1), (1, 32, 130, 32)])
def test_topk_matches_plain(device, rng, b, m, n, k):
    d = torch.from_numpy(rng.rand(b, m, n).astype(np.float32)).to(device)
    before = topk_ops.launches
    gi, gv = ops.topk_extract(d, k)
    torch.cuda.synchronize()
    assert topk_ops.launches == before + 1
    ri, rv = topk_ops._topk_extract_torch(d, k)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)


def test_topk_ties(device, rng):
    d = rng.rand(2, 64, 240).astype(np.float32)
    d[:, :, ::13] = d[:, :, 0:1]
    d[:, ::5] = 0.25
    d = torch.from_numpy(d).to(device)
    gi, gv = ops.topk_extract(d, 20)
    ri, rv = topk_ops._topk_extract_torch(d, 20)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)


def _tied_price_inputs(rng, b, m, n, device):
    base = (rng.rand(b, m, n).astype(np.float32) - 0.5) * 4
    base[:, :, ::5] = base[:, :, 1:2]
    price = rng.rand(b, n).astype(np.float32) * 2
    price[:, n // 3:n // 2] = price[:, :1]
    return torch.from_numpy(base).to(device), torch.from_numpy(price).to(device)


@pytest.mark.parametrize("b,m,n,k", [(4, 256, 4096, 2), (4, 256, 4096, 3), (2, 512, 1000, 2),
                                     (1, 40, 77, 8), (2, 64, 512, 20)])
def test_price_matches_plain(device, rng, b, m, n, k):
    """K6: the auction's k=2, the generic k, tied base columns and prices."""
    base, price = _tied_price_inputs(rng, b, m, n, device)
    before = topk_ops.price_launches
    gi, gv = ops.topk_extract_price(base, price, k)
    torch.cuda.synchronize()
    assert topk_ops.price_launches == before + 1
    ri, rv = topk_ops._topk_extract_price_torch(base, price, k)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)


@pytest.mark.parametrize("k", [2, 9])
def test_chunked_matches_flat(device, rng, k):
    """K4 at n=8192 against flat K3, its two-level plain version and the
    flat plain version, with ties; one launch, counted under K4 alone."""
    d = rng.rand(1, 256, 8192).astype(np.float32)
    d[:, :, ::13] = d[:, :, 0:1]
    d = torch.from_numpy(d).to(device)
    before = topk_ops.chunked_launches, topk_ops.launches
    gi, gv = ops.topk_extract_chunked(d, k)
    torch.cuda.synchronize()
    assert (topk_ops.chunked_launches, topk_ops.launches) == (before[0] + 1, before[1])
    fi, fv = ops.topk_extract(d, k)
    ti, tv = topk_ops._topk_extract_chunked_torch(d, k, 64)
    ri, rv = topk_ops._topk_extract_torch(d, k)
    assert torch.equal(gi, fi) and torch.equal(gv, fv)
    assert torch.equal(gi, ti) and torch.equal(gv, tv)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)


def _split_row_inputs(rng, b, m, n, device):
    """Random rows with tied columns, a few all-equal rows, and a price row
    per batch element with a run of equal prices."""
    base = (rng.rand(b, m, n).astype(np.float32) - 0.5) * 4
    base[:, :, ::5] = base[:, :, 1:2]
    base[:, ::9] = 0.75
    price = rng.rand(b, n).astype(np.float32) * 2
    price[:, n // 3:n // 2] = price[:, :1]
    return torch.from_numpy(base).to(device), torch.from_numpy(price).to(device)


def _split_row_ids(rng, b, m, r, device):
    """(b, r) ids into m rows with the auction's unit column stride and a
    row stride of r + 1 (a slice, as the active set's ids are): unsorted,
    repeated, the sentinel m and the last row, different per batch
    element."""
    ids = rng.randint(0, m + 1, (b, r + 1))
    ids[:, ::6] = ids[:, 2:3]
    ids[:, 1::11] = m
    ids[:, 3] = m - 1
    return torch.from_numpy(ids.astype(np.int64)).to(device)[:, :r]


@pytest.mark.parametrize("warps", topk_ops.WARPS)
@pytest.mark.parametrize("mode", ["plain", "price", "rows"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 32])
def test_split_row_matches_plain(device, rng, warps, mode, k):
    """The top-k kernel at every built warps-per-row count S, on K3's
    matrix, K6's base + price and K6 through row ids: n = 256 (S = 8 at
    k = 32 leaves each warp 32 columns), n = 1000 (not a multiple of
    4 * 32 * S), n = 4100 (float4 chunks at every S, the last one short)
    and n = 1027 (not a multiple of 4: only every fourth row is 16-byte
    aligned), tied columns and prices, all-equal rows; indices and values
    exactly equal, one launch per call."""
    b, m, r = 3, 64, 40
    for n in (256, 1000, 4100, 1027):
        base, price = _split_row_inputs(rng, b, m, n, device)
        if mode == "plain":
            before = topk_ops.launches
            got = topk_ops._topk_extract_cuda(base, k, warps=warps)
            want = topk_ops._topk_extract_torch(base, k)
            assert topk_ops.launches == before + 1
        else:
            ids = _split_row_ids(rng, b, m, r, device) if mode == "rows" else None
            before = topk_ops.price_launches
            got = topk_ops._topk_extract_price_cuda(base, price, k, ids, warps=warps)
            want = topk_ops._topk_extract_price_torch(base, price, k, ids)
            assert topk_ops.price_launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"n={n}"


@pytest.mark.parametrize("warps", topk_ops.WARPS)
def test_split_row_clamps_ids_into_range(device, rng, warps):
    """Row ids outside [0, m]: the kernel clamps them into [0, m - 1] as
    its plain version does (negative ids to row 0, ids past the sentinel
    to row m - 1), with no read of another batch element's rows."""
    b, m, n = 2, 16, 300
    base, price = _split_row_inputs(rng, b, m, n, device)
    ids = torch.tensor([[-1, 3, m, -(2 ** 40), m + 5, 0], [m - 1, -3, 7, m, -1, 2 ** 40]], device=device)
    got = topk_ops._topk_extract_price_cuda(base, price, 3, ids, warps=warps)
    want = topk_ops._topk_extract_price_torch(base, price, 3, ids)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    clamped = topk_ops._topk_extract_price_torch(base, price, 3, ids.clamp(0, m - 1))
    assert torch.equal(got[0], clamped[0]) and torch.equal(got[1], clamped[1])


def test_split_row_rejects_what_the_kernel_does_not_take(device):
    d = torch.rand(1, 8, 64, device=device)
    for warps in (0, 3, 16):
        with pytest.raises(ValueError):
            topk_ops._topk_extract_cuda(d, 2, warps=warps)
    with pytest.raises(ValueError):
        ops.topk_extract_price(d, torch.rand(1, 64, device=device), 2, torch.zeros(1, 4, dtype=torch.int32,
                                                                                      device=device))


def test_auction_tail_reads_rows_through_ids(device, rng, monkeypatch):
    """The auction at (2, 512) on the card: its active-set tail hands K6
    the row ids (no gathered copy), every sweep is one K6 launch, and the
    assignment and distances equal the plain kernels'."""
    emd = importlib.import_module("patchaugnet_tpu_torch.ops.emd")
    x1, x2 = _cloud(rng, 2, 512, device), _cloud(rng, 2, 512, device)
    tail = []

    def spy(neg_base, price, k, rows=None):
        tail.append(rows is not None)
        return ops.topk_extract_price(neg_base, price, k, rows)

    monkeypatch.setattr(emd, "topk_extract_price", spy)
    before = topk_ops.price_launches
    dist, assignment = ops.auction_emd(x1, x2, 0.02, 200)
    assert topk_ops.price_launches - before == emd.iterations + 1 == len(tail)
    assert any(tail) and not tail[0]
    monkeypatch.setattr(topk_ops, "_topk_extract_price_cuda", topk_ops._topk_extract_price_torch)
    plain_dist, plain_assignment = ops.auction_emd(x1, x2, 0.02, 200)
    assert torch.equal(assignment, plain_assignment) and torch.equal(dist, plain_dist)


def test_pair_runs_topk_kernel(device, rng):
    d = torch.from_numpy(rng.rand(2, 64, 200).astype(np.float32)).to(device)
    assert ops.topk_extract_pair is ops.topk_extract
    for k in (6, 7):
        before = topk_ops.launches
        gi, gv = ops.topk_extract_pair(d, k)
        assert topk_ops.launches == before + 1
        ri, rv = topk_ops._topk_extract_torch(d, k)
        assert torch.equal(gi, ri) and torch.equal(gv, rv)


@pytest.mark.parametrize("sweep", ["auto", "chunked"])
def test_auction_matches_plain_kernels(device, rng, monkeypatch, sweep):
    """The auction on the kernels against the same call on their plain
    versions, on the card: the price-fused sweep with its active-set tail
    (K6 once per iteration and once for the force-assign pass), and the
    dense sweep on K3."""
    emd = importlib.import_module("patchaugnet_tpu_torch.ops.emd")
    monkeypatch.setenv("PCR_EMD_SWEEP", sweep)
    x1, x2 = _cloud(rng, 2, 1024, device), _cloud(rng, 2, 1024, device)
    before = topk_ops.price_launches, topk_ops.launches
    dist, assignment = ops.auction_emd(x1, x2, 0.02, 200)
    sweeps = emd.iterations + 1
    launched = topk_ops.price_launches - before[0], topk_ops.launches - before[1]
    assert launched == ((sweeps, 0) if sweep == "auto" else (0, sweeps))
    for kernel, plain in (("_topk_extract_price_cuda", "_topk_extract_price_torch"),
                          ("_topk_extract_cuda", "_topk_extract_torch")):
        monkeypatch.setattr(topk_ops, kernel, getattr(topk_ops, plain))
    plain_dist, plain_assignment = ops.auction_emd(x1, x2, 0.02, 200)
    assert torch.equal(assignment, plain_assignment) and torch.equal(dist, plain_dist)


def test_emd_loss_gradient_on_card(device, rng):
    x1 = _cloud(rng, 2, 512, device).requires_grad_()
    x2 = _cloud(rng, 2, 512, device)
    loss = emd_loss(x1, x2, 0.02, 100)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(x1.grad).all() and x1.grad.abs().sum() > 0


def test_wide_knn_goes_through_topk_kernel(device, rng):
    x = torch.from_numpy(rng.rand(2, 90, 6).astype(np.float32)).to(device)
    q = torch.from_numpy(rng.rand(2, 24, 6).astype(np.float32)).to(device)
    before = topk_ops.launches, knn_ops.launches
    gi, _ = ops.knn(x, q, 5)
    assert (topk_ops.launches, knn_ops.launches) == (before[0] + 1, before[1])
    assert torch.equal(gi, topk_ops._topk_extract_torch(ops.pairwise_sqdist(q, x), 5)[0])


# ------------------------------------------------------------ train step
# the train step's batch: 4 queries x (1 + 2 + 14 + 1) clouds; the SA and
# FP levels at a quarter of the point count (1024 -> 256 -> 32 -> 4)
_TRAIN_B = 72
_TRAIN_LEVELS = (1024, 256, 32, 4)


def test_fps_and_knn_at_the_train_batch(device, rng):
    """K1 at the three SA levels and K2 at the three SA levels (k=20) and
    the three FP levels' 3-NN, at the train step's batch of 72: indices
    and d2 equal to the plain versions, one launch each."""
    x = [_cloud(rng, _TRAIN_B, _TRAIN_LEVELS[0], device)]
    for m in _TRAIN_LEVELS[1:]:
        before = fps_ops.launches
        idx = ops.farthest_point_sample(x[-1], m)
        assert fps_ops.launches == before + 1
        assert torch.equal(idx, fps_ops._farthest_point_sample_torch(x[-1], m))
        x.append(ops.gather(x[-1], idx))
    cases = [(x[lv], x[lv + 1], min(20, x[lv].shape[1])) for lv in range(3)]
    cases += [(x[lv + 1], x[lv], 3) for lv in range(3)]
    for pts, qry, k in cases:
        before = knn_ops.launches
        gi, gd = ops.knn(pts, qry, k)
        assert knn_ops.launches == before + 1
        ri, rd = knn_ops._knn_torch(pts, qry, k)
        assert torch.equal(gi, ri) and torch.equal(gd, rd)


# PPT-Net's SA levels (configs/pptnet_origin.yaml): 4096 -> 1024 -> 256 -> 64 -> 16
_PPT_LEVELS = (4096, 1024, 256, 64, 16)


@pytest.mark.parametrize("b", [18, 32, 100])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_fps_and_knn_at_pptnet_levels(device, rng, b, ties):
    """K1 at PPT-Net's four SA levels (n = 4096, 1024, 256, 64: layouts
    (512, 8), (1024, 1), (32, 8), (32, 2)) and K2 at its four SA levels
    (k=20) and four FP levels' 3-NN, at the serving, eval and tuple
    batches: indices and d2 equal to the plain versions, one launch each."""
    x = [_cloud(rng, b, _PPT_LEVELS[0], device, ties=ties)]
    for m in _PPT_LEVELS[1:]:
        before = fps_ops.launches
        idx = ops.farthest_point_sample(x[-1], m)
        assert fps_ops.launches == before + 1
        assert torch.equal(idx, fps_ops._farthest_point_sample_torch(x[-1], m))
        x.append(ops.gather(x[-1], idx))
    cases = [(x[lv], x[lv + 1], 20) for lv in range(4)] + [(x[lv + 1], x[lv], 3) for lv in range(4)]
    for pts, qry, k in cases:
        before = knn_ops.launches
        gi, gd = ops.knn(pts, qry, k)
        assert knn_ops.launches == before + 1
        ri, rd = knn_ops._knn_torch(pts, qry, k)
        assert torch.equal(gi, ri) and torch.equal(gd, rd), (pts.shape[1], qry.shape[1], k)


def _tiny_train_batch(rng, cfg):
    """Seeded clouds, mask (queries and positives) and correspondence
    tables for ``cfg``'s tuple batch; pair 2 has no valid row."""
    from patchaugnet_tpu_torch.losses import PatchCorrespondences

    b, p = cfg["TRAIN_BATCH_SIZE"], cfg["TRAIN_POSITIVES_PER_QUERY"]
    t = 1 + p + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 1
    clouds = rng.rand(b * t, cfg["NUM_POINTS"], 3).astype(np.float32)
    mask = np.zeros(b * t, bool)
    for q in range(b):
        mask[q * t: q * t + 1 + p] = True
    rows = cfg["A2B_MAX_ROWS"]
    pair = rng.randint(0, 3, rows).astype(np.int32)
    q_cloud = (t * (pair % b)).astype(np.int32)
    slots = [torch.from_numpy(rng.randint(0, cfg["SAMPLING"][0], rows).astype(np.int32)) for _ in range(3)]
    corr = PatchCorrespondences(torch.from_numpy(q_cloud), torch.from_numpy(q_cloud + 1), *slots,
                                torch.from_numpy(pair), torch.from_numpy((rng.rand(rows) < 0.5) & (pair != 2)),
                                cfg["A2B_MAX_PAIRS"])
    return clouds, mask, corr


def test_train_step_matches_plain_kernels(device, rng, monkeypatch):
    """One train step at a tiny configuration on the kernels against the
    same step from a copy of the state under the plain versions, on the
    card: provenance indices equal, metrics and new BN running statistics
    within 1e-6 (the forward is the same arithmetic on equal indices);
    K1 3 and K2 6 launches."""
    import copy

    from patchaugnet_tpu_torch import configs, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    cfg = dict(configs.PATCH_AUG_NET_TRAIN, NUM_POINTS=128, SAMPLING=[32, 8, 4], KNN=[8, 8, 4],
               MAX_SAMPLES=[8, 32, 128], TRAIN_BATCH_SIZE=2, TRAIN_POSITIVES_PER_QUERY=1,
               TRAIN_NEGATIVES_PER_QUERY=2, A2B_MAX_ROWS=64, A2B_MAX_PAIRS=4)
    model = seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(0))
    state = train.create_train_state(model, cfg, device=device)
    plain = copy.deepcopy(state)
    clouds, mask, corr = _tiny_train_batch(rng, cfg)
    outs = []
    hooks = [s.model.register_forward_hook(lambda mod, args, out: outs.append(out)) for s in (state, plain)]
    counts = (fps_ops.launches, knn_ops.launches, topk_ops.launches)
    state, metrics = train.build_train_step(state.model, cfg)(state, clouds, corr, mask)
    torch.cuda.synchronize()
    after = (fps_ops.launches, knn_ops.launches, topk_ops.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (3, 6, 0)
    monkeypatch.setattr(fps_ops, "_fps_cuda", fps_ops._farthest_point_sample_torch)
    monkeypatch.setattr(knn_ops, "_knn_cuda", knn_ops._knn_torch)
    plain, want = train.build_train_step(plain.model, cfg)(plain, clouds, corr, mask)
    assert fps_ops.launches == after[0] and knn_ops.launches == after[1]
    for h in hooks:
        h.remove()
    for name in ("center_idx_origin", "sample_idx_origin"):
        for a, b in zip(getattr(outs[0], name), getattr(outs[1], name)):
            assert torch.equal(a, b), name
    assert set(metrics) == {"place_recognition", "patch_recon_a2a", "patch_recon_a2b", "total"}
    for key, value in want.items():
        torch.testing.assert_close(metrics[key], value, rtol=1e-6, atol=0)
        assert torch.isfinite(value) and value > 0, key
    for (name, a), b in zip(state.model.named_buffers(), plain.model.buffers()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=name)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


# ------------------------------------------------------------ past one list
@pytest.mark.parametrize("k,lanes", [(33, None), (96, 32), (97, None), (200, 32)])
def test_knn_past_one_list(device, rng, k, lanes):
    """``ops.knn`` at k past 32 (one list of up to 96 pairs) and past 96
    (passes of 96 in the one launch), with ties: one launch, equal to the
    plain version."""
    x, q = _cloud(rng, 2, 300, device, ties=True), _cloud(rng, 2, 50, device, ties=True)
    before = knn_ops.launches
    gi, gd = ops.knn(x, q, k) if lanes is None else knn_ops._knn_cuda(x, q, k, lanes=lanes)
    torch.cuda.synchronize()
    assert knn_ops.launches == before + 1
    ri, rd = knn_ops._knn_torch(x, q, k)
    assert torch.equal(gi, ri) and torch.equal(gd, rd)


def test_knn_past_65535_clouds(device, rng):
    """More clouds than a grid's second axis takes: one launch."""
    many = _cloud(rng, 65536 + 7, 8, device)
    before = knn_ops.launches
    gi, gd = ops.knn(many, many, 2)
    torch.cuda.synchronize()
    assert knn_ops.launches == before + 1
    ri, rd = knn_ops._knn_torch(many, many, 2)
    assert torch.equal(gi, ri) and torch.equal(gd, rd)


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [33, 40, 100])
def test_topk_past_one_list(device, rng, warps, k):
    """The top-k kernel at k past 32 (passes of 32 in the one launch), for
    K3, K6 with and without row ids and K4, at every S, on rows with ties:
    equal to the plain versions."""
    d = torch.from_numpy(rng.randint(0, 50, (2, 24, 1000)).astype(np.float32)).to(device)
    price = torch.from_numpy(rng.randint(0, 3, (2, 1000)).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.randint(0, 25, (2, 16))).to(device)
    before = topk_ops.launches, topk_ops.price_launches, topk_ops.chunked_launches
    for got, want in ((topk_ops._topk_extract_cuda(d, k, warps=warps), topk_ops._topk_extract_torch(d, k)),
                      (topk_ops._topk_extract_price_cuda(d, price, k, warps=warps),
                       topk_ops._topk_extract_price_torch(d, price, k)),
                      (topk_ops._topk_extract_price_cuda(d, price, k, ids, warps=warps),
                       topk_ops._topk_extract_price_torch(d, price, k, ids)),
                      (topk_ops._topk_extract_chunked_cuda(d, k, warps=warps), topk_ops._topk_extract_torch(d, k))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (topk_ops.launches, topk_ops.price_launches, topk_ops.chunked_launches) == (
        before[0] + 1, before[1] + 2, before[2] + 1)


def test_public_topk_wrappers_past_one_list(device, rng):
    """``ops.topk_extract``, ``topk_extract_price`` and
    ``topk_extract_chunked`` at k = 40 launch the kernel."""
    d = torch.from_numpy(rng.rand(2, 64, 4096).astype(np.float32)).to(device)
    price = torch.from_numpy(rng.rand(2, 4096).astype(np.float32)).to(device)
    ids = torch.from_numpy(rng.randint(0, 65, (2, 16))).to(device)
    before = topk_ops.launches, topk_ops.price_launches, topk_ops.chunked_launches
    for got, want in ((ops.topk_extract(d, 40), topk_ops._topk_extract_torch(d, 40)),
                      (ops.topk_extract_price(d, price, 40), topk_ops._topk_extract_price_torch(d, price, 40)),
                      (ops.topk_extract_price(d, price, 40, ids),
                       topk_ops._topk_extract_price_torch(d, price, 40, ids)),
                      (ops.topk_extract_chunked(d, 40), topk_ops._topk_extract_torch(d, 40))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (topk_ops.launches, topk_ops.price_launches, topk_ops.chunked_launches) == (
        before[0] + 1, before[1] + 2, before[2] + 1)


def _pyramid_tensors(pyramid):
    out = [t for table in pyramid.tables for t in table]
    out += [pyramid.conv0_routes, pyramid.overflow, *pyramid.block_routes, *pyramid.down_routes]
    return out + [t for pair in pyramid.up_nbr for t in pair]


@pytest.mark.parametrize("capacity", [None, "half"], ids=["full", "overflowing"])
def test_minkloc_on_card_matches_cpu(device, rng, capacity):
    """MinkLoc3Dv2 at full width (step 0.01) on the card against the CPU:
    coords, every table, route and up map equal; descriptors within 1e-5;
    at full capacity and at capacities of half the occupancy (the highest
    keys drop). No kernel of the port runs on this path."""
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.models import minkloc_sparse as ms
    from patchaugnet_tpu_torch.nn import seeded_init_

    clouds = torch.from_numpy(rng.rand(3, 4096, 3).astype(np.float32) * 2 - 1)
    cfg = dict(configs.MINKLOC3DV2)
    if capacity:
        counts = ms.measure_level_occupancy(clouds.numpy(), num_levels=4)
        cfg["level_capacity"] = [int(c) // 2 for c in counts.max(axis=0)]
    model = seeded_init_(get_model("minkloc3dv2", cfg), torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        want = model(clouds)
        cpu = model.pyramid(clouds)
        coords = model.quantize(clouds)[:2]
        got = serving.build_forward_fn(model, device=device)(clouds)
        card = model.pyramid(clouds.to(device))
        for a, b in zip(model.quantize(clouds.to(device))[:2], coords):
            assert torch.equal(a.cpu(), b)
    assert card.dims == cpu.dims and (int(card.overflow) > 0) == bool(capacity)
    for a, b in zip(_pyramid_tensors(card), _pyramid_tensors(cpu)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("model_type, cfg_name", [("patch_aug_net", "PATCH_AUG_NET"), ("pptnet", "PPTNET_ORIGIN"),
                                                  ("pointnet_vlad", "POINTNET_VLAD"), ("minkloc3dv2", "MINKLOC3DV2")])
def test_bf16_forward_on_card_matches_f32(device, rng, model_type, cfg_name):
    """Each family at full width with ``COMPUTE_DTYPE: bfloat16`` on the
    card, on the f32 model's weights: f32 descriptors within cosine 0.999
    of the f32 forward's on the card, the same kernel launches, and the
    same provenance indices (PatchAugNet, PPT-Net)."""
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    cfg = getattr(configs, cfg_name)
    serving.resolve_device(device)                 # TF32 and bf16 reductions off
    f32 = seeded_init_(get_model(model_type, cfg), torch.Generator().manual_seed(0)).to(device).eval()
    bf16 = get_model(model_type, dict(cfg, COMPUTE_DTYPE="bfloat16")).to(device).eval()
    bf16.load_state_dict(f32.state_dict())
    clouds = torch.from_numpy(rng.rand(4, 4096, 3).astype(np.float32)).to(device)
    outs, launches = [], []
    for model in (f32, bf16):
        fps_ops.launches = knn_ops.launches = 0
        with torch.inference_mode():
            outs.append(model(clouds))
        launches.append((fps_ops.launches, knn_ops.launches))
    assert launches[0] == launches[1]
    d32, d16 = (serving.global_desc(o) for o in outs)
    assert d16.dtype == torch.float32 and torch.isfinite(d16).all()
    assert torch.nn.functional.cosine_similarity(d16, d32, dim=-1).min().item() >= 0.999
    for a, b in zip(getattr(outs[0], "center_idx_origin", ()), getattr(outs[1], "center_idx_origin", ())):
        assert torch.equal(a, b)


def test_sharded_knn_over_two_ranks_on_one_card(device, rng):
    """``parallel.sharded_knn`` over two gloo ranks sharing the card: each
    rank's K2 on its half of the points, the lists merged, equals K2 on the
    whole cloud, indices and distances bit for bit, on both ranks."""
    from patchaugnet_tpu_torch import parallel

    import torch_parallel_worker

    xyz = rng.rand(2, 4096, 3).astype(np.float32)
    q = xyz[:, ::4].copy()
    for idx, d2, ref_idx, ref_d2 in parallel.spawn(torch_parallel_worker.knn_on_one_card, 2, args=(xyz, q, 20),
                                                    platform="gpu", share_device=True):
        assert torch.equal(idx, ref_idx) and torch.equal(d2, ref_d2)


norm_ops = importlib.import_module("patchaugnet_tpu_torch.ops.norm")

# (rows, C) of every eval BatchNorm -> ReLU site at B=4 (PatchAugNet's, then
# PPT-Net's that differ), the first SA level's and the first FP level's at B=100,
# channel counts that are not a multiple of 4 (the scalar path), an unaligned row
# count, and large tensors on both paths
_BN_RELU_SHAPES = [(81920, 32), (81920, 64), (10240, 64), (10240, 256), (1280, 256), (1280, 512), (512, 256),
                   (4096, 256), (16384, 256), (4096, 64), (20480, 64), (20480, 128), (1024, 128), (5120, 128),
                   (5120, 256), (256, 256), (64, 512), (2048000, 32), (409600, 256),
                   (1000, 3), (777, 1), (513, 30), (100, 1026), (12345, 32), (2000000, 30), (300000, 1020)]


def _bn_relu_inputs(rng, rows, c, device, specials=True):
    x = (rng.randn(rows, c) * 3).astype(np.float32)
    if specials and x.size:
        flat = x.reshape(-1)
        flat[rng.randint(0, flat.size, 64)] = np.nan
        flat[rng.randint(0, flat.size, 64)] = np.inf
        flat[rng.randint(0, flat.size, 64)] = -np.inf
        flat[rng.randint(0, flat.size, 64)] = 0.0
    mean = (rng.randn(c) * 0.1).astype(np.float32)
    mul = (rng.rand(c) + 0.5).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    if c > 2:
        mul[1], mean[2] = 0.0, np.inf     # inf * 0 and inf - inf: NaNs made inside
    return [torch.from_numpy(a).to(device) for a in (x, mean, mul, bias)]


def _passes(x, mean, mul, bias):
    """The four torch passes of an eval BatchNorm and ``torch.relu``."""
    return torch.relu((x - mean) * mul + bias)


@pytest.mark.parametrize("rows,c", _BN_RELU_SHAPES)
def test_bn_relu_matches_the_four_passes(device, rng, rows, c):
    """The kernel's result equals the four torch passes on the card in
    every bit, NaN, infinities and signed zeros included, through the
    float4 path and the scalar one."""
    x, mean, mul, bias = _bn_relu_inputs(rng, rows, c, device)
    before = norm_ops.launches
    got = ops.bn_relu(x, mean, mul, bias)
    assert norm_ops.launches == before + 1
    assert got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), _passes(x, mean, mul, bias).view(torch.int32))


@pytest.mark.parametrize("c", [32, 3])
def test_bn_relu_unaligned_input_and_no_rows(device, rng, c):
    """An input that starts off a 16-byte boundary takes the scalar path
    and gives the same bits; a tensor of zero rows launches nothing."""
    x, mean, mul, bias = _bn_relu_inputs(rng, 301, c, device)
    shifted = torch.empty(x.numel() + 1, device=device)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    got = ops.bn_relu(shifted, mean, mul, bias)
    assert torch.equal(got.view(torch.int32), _passes(x, mean, mul, bias).view(torch.int32))
    before = norm_ops.launches
    empty = ops.bn_relu(x[:0], mean, mul, bias)
    assert empty.shape == (0, c) and norm_ops.launches == before


def test_bn_relu_rejects_what_the_kernel_does_not_take(device, rng):
    x, mean, mul, bias = _bn_relu_inputs(rng, 64, 32, device, specials=False)
    for bad in (x.t().contiguous().t(), x.double(), x.to(torch.bfloat16), x[:, :30].contiguous()):
        with pytest.raises(ValueError, match="pan::bn_relu"):
            ops.bn_relu(bad, mean, mul, bias)
    for bad in (mul[:16], mul.cpu(), mul.double(), torch.stack([mul, mul], 1)[:, 0]):
        with pytest.raises(ValueError, match="mul"):
            ops.bn_relu(x, mean, bad, bias)


@pytest.mark.parametrize("model_type, cfg_name, sites", [("patch_aug_net", "PATCH_AUG_NET", 16),
                                                         ("pptnet", "PPTNET_ORIGIN", 25),
                                                         ("pointnet_vlad", "POINTNET_VLAD", 4)])
def test_eval_forward_fused_matches_unfused(device, rng, monkeypatch, model_type, cfg_name, sites):
    """The full-width eval forward at B=4 on the card: one ``pan::bn_relu``
    launch per BatchNorm -> ReLU site, and every output equal in every bit
    to the forward with the fused path switched off."""
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import BatchNorm, seeded_init_

    serving.resolve_device(device)
    model = seeded_init_(get_model(model_type, getattr(configs, cfg_name)), torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    clouds = torch.from_numpy(rng.rand(4, 4096, 3).astype(np.float32)).to(device)
    before = norm_ops.launches
    with torch.inference_mode():
        fused = model(clouds)
    assert norm_ops.launches == before + sites
    monkeypatch.setattr(BatchNorm, "relu", lambda self, x: torch.relu(self(x)))
    with torch.inference_mode():
        unfused = model(clouds)
    assert norm_ops.launches == before + sites
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(fused), leaves(unfused), strict=True):
        assert a is b is None or (a.dtype == b.dtype and torch.equal(a, b))
    assert torch.isfinite(serving.global_desc(fused)).all()
