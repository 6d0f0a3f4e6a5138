"""The port's reconstruction-loss slice against the JAX package, on the CPU.

Kernels K4-K6 (plain versions here) against the JAX Pallas kernels in
interpret mode, and the auction EMD, the chamfer ops and the
reconstruction losses against the JAX functions, on the same numpy
inputs. Indices and assignments must be exactly equal, distances, loss
values and xyz1 gradients within 1e-6.

The JAX references for 512-point clouds run its row-chunked auction
branch (``row_chunk=256``, or a smaller ``_VALUE_BUDGET`` where the API
takes no chunk): XLA-CPU's ``top_k`` over the dense ``(2, 512, 512)``
matrix costs about 0.16 s per auction iteration, the chunked branch a few
milliseconds, and the JAX package's own tests hold its branches to the
same assignment. The port at these sizes takes its price-fused sweep and
active-set tail (n=512 > R=256), as the JAX package does on a TPU.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import patchaugnet_tpu.ops.emd as jemd
from patchaugnet_tpu import losses as jlosses
from patchaugnet_tpu import ops as jops
from patchaugnet_tpu.ops.pallas.knn import (
    topk_extract_chunked as jax_topk_extract_chunked,
    topk_extract_pair_pallas,
    topk_extract_price_pallas,
)

import patchaugnet_tpu_torch.ops.emd as pemd
from patchaugnet_tpu_torch import losses, ops

EPS = 0.02
ITERS = 120
_RNG = np.random.RandomState(1)
X1 = _RNG.rand(2, 512, 3).astype(np.float32)
X2 = _RNG.rand(2, 512, 3).astype(np.float32)
_JAX_REFS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module. The auction makes thousands of
    small torch calls; with a thread pool each, they spin against the
    other test processes (measured 206 s for this file under six pytest
    workers against 31 s alone), and tensors this small gain nothing
    from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("k", [2, 3])
def test_price_extraction_matches_jax(rng, k):
    """K6's plain version: k=2 is the auction's form (``_extract_price2_kernel``),
    k=3 the generic loop; tied base columns."""
    base = (rng.rand(2, 64, 512).astype(np.float32) - 0.5) * 4
    base[:, :, ::5] = base[:, :, 1:2]
    price = rng.rand(2, 512).astype(np.float32) * 2
    price[:, 100:140] = price[:, 99:100]
    gi, gv = ops.topk_extract_price(_t(base), _t(price), k)
    assert gi.dtype == torch.int32 and gi.shape == (2, 64, k)
    ri, rv = topk_extract_price_pallas(jnp.asarray(base), jnp.asarray(price), k, query_block=64,
                                       interpret=True)
    np.testing.assert_array_equal(_np(ri), gi.numpy())
    np.testing.assert_array_equal(_np(rv), gv.numpy())


@pytest.mark.parametrize("shape,k,num_chunks", [((2, 64, 240), 9, 4), ((2, 64, 240), 9, None),
                                                ((1, 32, 40), 20, None)])
def test_chunked_extraction_matches_jax(rng, shape, k, num_chunks):
    """K4: explicit and default chunk counts with ties, and the fall back to
    the flat extraction when the chunks are narrower than k."""
    d = rng.rand(*shape).astype(np.float32)
    d[:, :, ::13] = d[:, :, 0:1]
    gi, gv = ops.topk_extract_chunked(_t(d), k, num_chunks=num_chunks)
    ri, rv = jax_topk_extract_chunked(jnp.asarray(d), k, shape[1], num_chunks=num_chunks,
                                      interpret=True)
    np.testing.assert_array_equal(_np(ri), gi.numpy())
    np.testing.assert_array_equal(_np(rv), gv.numpy())
    fi, fv = ops.topk_extract(_t(d), k)
    assert torch.equal(gi, fi) and torch.equal(gv, fv)


@pytest.mark.parametrize("k", [6, 7])
def test_pair_extraction_matches_jax(rng, k):
    """K5, even and odd k (the TPU kernel's dead second extraction)."""
    d = rng.rand(2, 64, 200).astype(np.float32)
    gi, gv = ops.topk_extract_pair(_t(d), k)
    ri, rv = topk_extract_pair_pallas(jnp.asarray(d), k, query_block=64, interpret=True)
    np.testing.assert_array_equal(_np(ri), gi.numpy())
    np.testing.assert_array_equal(_np(rv), gv.numpy())


def _jax_auction(row_chunk=256, unass_floor=0, eps_schedule=None):
    key = (row_chunk, unass_floor, eps_schedule)
    if key not in _JAX_REFS:
        dist, assignment = jops.auction_emd(jnp.asarray(X1), jnp.asarray(X2), EPS, ITERS,
                                            row_chunk, unass_floor, eps_schedule)
        _JAX_REFS[key] = (_np(dist), _np(assignment))
    return _JAX_REFS[key]


_K6, _K3, _K4 = "topk_extract_price", "topk_extract", "topk_extract_chunked"
# (port keyword arguments, port environment, port tile budget, the one
# extraction wrapper the sweep calls, JAX keyword arguments)
_AUCTION_CASES = {
    "fused_active": ({}, {}, None, _K6, {}),
    "row_chunk": ({"row_chunk": 128}, {}, None, _K6, {"row_chunk": 128}),
    "row_chunk_sweep": ({"row_chunk": 128}, {"PCR_EMD_SWEEP": "chunked"}, None, _K3,
                        {"row_chunk": 128}),
    "dense_k4": ({}, {"PCR_EMD_SWEEP": "chunked"}, 256 * 256, _K4, {}),
    "active_r128": ({}, {}, 256 * 256, _K6, {}),
    "active_off": ({}, {"PCR_EMD_ACTIVE": "off"}, None, _K6, {}),
    "unass_floor_4": ({"unass_floor": 4}, {}, None, _K6, {"unass_floor": 4}),
    "unass_floor_20": ({"unass_floor": 20}, {}, None, _K6, {"unass_floor": 20}),
    "eps_schedule": ({"eps_schedule": (10.0, 1.0)}, {}, None, _K6, {"eps_schedule": (10.0, 1.0)}),
}


@pytest.mark.parametrize("case", list(_AUCTION_CASES))
def test_auction_matches_jax(monkeypatch, case):
    """Every sweep of the port against the JAX auction: price-fused with
    the active-set tail at R=256 and (smaller tile budget) R=128, without
    the tail, row-chunked with K3, dense with K4 (the budget makes a
    256-row block of 512 columns too wide for the flat tile), and the
    ``unass_floor`` (20 exits at iteration 54) and ``eps_schedule`` modes.
    The wrapper each sweep must go through is counted."""
    kwargs, env, budget, wrapper, jax_kwargs = _AUCTION_CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if budget is not None:
        monkeypatch.setattr(pemd, "_VMEM_TILE_BUDGET", budget)
    calls = {}
    for fn_name in (_K6, _K3, _K4):
        def spy(*args, _fn=getattr(pemd, fn_name), _name=fn_name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(pemd, fn_name, spy)
    dist, assignment = ops.auction_emd(_t(X1), _t(X2), EPS, ITERS, **kwargs)
    sweeps = pemd.iterations + 1                          # the force-assign pass included
    per_sweep = 512 // kwargs["row_chunk"] if wrapper == _K3 else 1
    assert calls == {wrapper: per_sweep * sweeps}
    assert assignment.dtype == torch.int32 and dist.shape == (2, 512)
    ref_dist, ref_assignment = _jax_auction(**jax_kwargs)
    np.testing.assert_array_equal(ref_assignment, assignment.numpy())
    np.testing.assert_allclose(ref_dist, dist.numpy(), atol=1e-6, rtol=0)


def test_auction_bad_inputs_raise():
    with pytest.raises(ValueError):
        ops.auction_emd(torch.zeros(2, 8, 3), torch.zeros(2, 9, 3))
    with pytest.raises(ValueError, match="does not divide"):
        ops.auction_emd(torch.zeros(1, 12, 3), torch.zeros(1, 12, 3), row_chunk=5)
    with pytest.raises(ValueError, match="price"):
        ops.topk_extract_price(torch.zeros(2, 4, 6), torch.zeros(2, 5), 2)


@pytest.mark.parametrize("name", ["chamfer_l1", "chamfer_l2", "chamfer_l2_split"])
def test_chamfer_ops_match_jax(rng, name):
    a = rng.rand(2, 100, 3).astype(np.float32)
    b = rng.rand(2, 70, 3).astype(np.float32)
    ref = getattr(jops, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(ops, name)(_t(a), _t(b))
    got = torch.stack(got) if isinstance(got, tuple) else got
    np.testing.assert_allclose(_np(ref), got.numpy(), atol=1e-6, rtol=0)


def _loss_case(name, rng):
    """(port loss, JAX loss, xyz1, other args as numpy)."""
    if name in ("emd_loss", "chamfer_loss", "point_pair_loss"):
        if name == "emd_loss":
            return (lambda p, q: losses.emd_loss(p, q, EPS, ITERS),
                    lambda p, q: jlosses.emd_loss(p, q, EPS, ITERS), X1, (X2,))
        a = rng.rand(2, 256, 3).astype(np.float32)
        b = rng.rand(2, 256, 3).astype(np.float32)
        return getattr(losses, name), getattr(jlosses, name), a, (b,)
    o = rng.rand(2, 8, 20, 3).astype(np.float32)
    r = rng.rand(2, 8, 20, 3).astype(np.float32)
    mask = np.array([True, False])
    return getattr(losses, name), getattr(jlosses, name), o, (r, mask)


@pytest.mark.parametrize("name", ["emd_loss", "patch_emd_loss", "chamfer_loss",
                                  "patch_chamfer_loss", "point_pair_loss"])
def test_loss_and_grad_match_jax(monkeypatch, rng, name):
    """Values and xyz1 gradients against ``jax.value_and_grad`` (patch
    losses on (2, 8, 20, 3) stacks with a cloud mask; patch EMD at n=20
    takes the dense sweep on both sides, on K3 in the port)."""
    port_fn, jax_fn, x, rest = _loss_case(name, rng)
    monkeypatch.setattr(jemd, "_VALUE_BUDGET", 2 * 256 * 512)   # JAX's chunked branch at n=512
    ref, ref_grad = jax.value_and_grad(lambda p: jax_fn(p, *map(jnp.asarray, rest)))(jnp.asarray(x))
    px = _t(x).requires_grad_()
    others = [_t(a).requires_grad_() if a.dtype == np.float32 else _t(a) for a in rest]
    got = port_fn(px, *others)
    got.backward()
    np.testing.assert_allclose(float(ref), got.item(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(ref_grad), px.grad.numpy(), atol=1e-6, rtol=0)
    if "emd" in name:   # the EMD gradient flows to xyz1 only
        assert not others[0].grad.any()
