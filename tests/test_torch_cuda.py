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
to agree bit for bit). The top-k kernels (K3, and K4-K6 built on the same
row scan) and the auction EMD that runs them are held to exact equality.
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


@pytest.mark.parametrize("b,n,m", [(2, 64, 16), (3, 100, 25), (2, 1024, 128), (2, 4096, 1024),
                                   (1, 3000, 77), (1, 9000, 40), (2, 12, 20)])
def test_fps_matches_plain(device, rng, b, n, m):
    """Every register-width instantiation, the scratch-row path (n > 8192)
    and m > n."""
    x = _cloud(rng, b, n, device)
    before = fps_ops.launches
    got = ops.farthest_point_sample(x, m)
    torch.cuda.synchronize()
    assert fps_ops.launches == before + 1
    assert torch.equal(got, fps_ops._farthest_point_sample_torch(x, m))


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
    """K4 at n=8192 against flat K3 and the plain version, with ties; its
    two K3 kernel launches count under K4 alone."""
    d = rng.rand(1, 256, 8192).astype(np.float32)
    d[:, :, ::13] = d[:, :, 0:1]
    d = torch.from_numpy(d).to(device)
    before = topk_ops.chunked_launches, topk_ops.launches
    gi, gv = ops.topk_extract_chunked(d, k)
    torch.cuda.synchronize()
    assert (topk_ops.chunked_launches, topk_ops.launches) == (before[0] + 2, before[1])
    fi, fv = ops.topk_extract(d, k)
    ri, rv = topk_ops._topk_extract_torch(d, k)
    assert torch.equal(gi, fi) and torch.equal(gv, fv)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)


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
