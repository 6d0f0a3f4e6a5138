"""The port's point ops and heads against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (the Pallas kernels in
interpret mode, or the XLA versions) and through the port, whose kernel
wrappers take their plain torch versions for CPU tensors. Indices must be
exactly equal; squared distances agree to 1e-6 (the JAX side may contract
a multiply-add where the port rounds twice); features and descriptors to
the tolerance stated at each test.
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import ops as jops
from patchaugnet_tpu.nn import MLP as JMLP
from patchaugnet_tpu.nn import SpatialPyramidNetVLAD as JSPVLAD
from patchaugnet_tpu.ops.fps import _farthest_point_sample_xla
from patchaugnet_tpu.ops.pallas.fps import farthest_point_sample_pallas
from patchaugnet_tpu.ops.pallas.knn import knn_fused_pallas, topk_extract_pallas

from patchaugnet_tpu_torch import ops
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.nn import MLP, SpatialPyramidNetVLAD
from patchaugnet_tpu_torch.ops import contracts


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


def _tied_cloud(rng, b, n):
    """Points on a coarse integer grid, with exact duplicates: many
    distances are exactly equal, so every pick goes through a tie-break."""
    pts = rng.randint(0, 4, size=(b, n, 3)).astype(np.float32)
    pts[:, 1::7] = pts[:, 0:1]
    return pts


def random_batch_stats(tree, rng):
    """Replace every BN mean/var leaf with values away from 0/1."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = random_batch_stats(val, rng)
        elif key == "var":
            out[key] = (rng.rand(*val.shape) + 0.5).astype(np.float32)
        else:
            out[key] = (rng.randn(*val.shape) * 0.2).astype(np.float32)
    return out


class TestFPS:
    @pytest.mark.parametrize("b,n,m", [(2, 64, 16), (4, 512, 128), (3, 100, 25)])
    def test_random_matches_jax(self, rng, b, n, m):
        x = rng.rand(b, n, 3).astype(np.float32)
        got = ops.farthest_point_sample(_t(x), m)
        assert got.dtype == torch.int32 and got.shape == (b, m)
        np.testing.assert_array_equal(_np(_farthest_point_sample_xla(jnp.asarray(x), m)), got.numpy())
        np.testing.assert_array_equal(
            _np(farthest_point_sample_pallas(jnp.asarray(x), m, interpret=True)), got.numpy()
        )

    def test_all_equal_cloud_picks_zeros(self):
        got = ops.farthest_point_sample(torch.ones(1, 32, 3), 8)
        np.testing.assert_array_equal(got.numpy(), 0)
        ref = farthest_point_sample_pallas(jnp.ones((1, 32, 3)), 8, interpret=True)
        np.testing.assert_array_equal(_np(ref), 0)

    def test_ties_match_jax(self, rng):
        x = _tied_cloud(rng, 3, 96)
        got = ops.farthest_point_sample(_t(x), 40).numpy()
        np.testing.assert_array_equal(
            _np(farthest_point_sample_pallas(jnp.asarray(x), 40, interpret=True)), got
        )
        np.testing.assert_array_equal(_np(_farthest_point_sample_xla(jnp.asarray(x), 40)), got)

    @pytest.mark.parametrize("m", [1, 20])
    def test_m_edge_cases(self, rng, m):
        """m == 1 is all zeros; m > n repeats indices, as the JAX loop does."""
        x = rng.rand(2, 12, 3).astype(np.float32)
        got = ops.farthest_point_sample(_t(x), m).numpy()
        np.testing.assert_array_equal(_np(_farthest_point_sample_xla(jnp.asarray(x), m)), got)

    def test_bad_inputs_raise(self):
        with pytest.raises(ValueError):
            ops.farthest_point_sample(torch.zeros(2, 8, 2), 4)
        with pytest.raises(ValueError):
            ops.farthest_point_sample(torch.zeros(2, 8, 3), 0)


def test_fps_layout_rule():
    """Every n maps to a layout the kernel is built for that holds it,
    and the kernel is built for no layout the rule never picks; n > 8192
    takes the scratch path, n <= 32 x the one-warp points per thread one
    warp; the SA levels take the layouts PERF.md records."""
    fps = importlib.import_module("patchaugnet_tpu_torch.ops.fps")
    picked = {n: fps.layout_for(n) for n in range(1, 10001)}
    for n, (threads, ppt) in picked.items():
        assert (threads, ppt) in fps.LAYOUTS
        assert ((threads, ppt) == fps.SCRATCH) == (n > 8192)
        assert ppt == 0 or threads * ppt >= n
        assert (threads == 32) == (n <= 32 * fps.WARP_MAX_PPT)
    assert set(picked.values()) == set(fps.LAYOUTS)
    assert [fps.layout_for(n) for n in (4096, 1024, 128)] == [(512, 8), (1024, 1), (32, 4)]


def test_warps_rule():
    """The top-k kernel's warps per row on a 132-SM card at the shapes of
    its paths (PERF.md): 4 for the auction's active-set tail, 2 for K4 at
    n=16384, b=4, and 1 for K4's 4096 rows of 8192, the full price-fused
    sweep and K3's matrices; always a count the kernel is built for, never
    more for more rows."""
    topk = importlib.import_module("patchaugnet_tpu_torch.ops.topk")
    shapes = {(4 * 256, 4096): 4, (4 * 4096, 4096): 1, (4096, 8192): 1, (4 * 512, 16384): 2,
              (32 * 4096, 1024): 1, (32 * 1024, 128): 1, (32 * 128, 16): 1}
    assert {shape: topk.warps_for(*shape, 132) for shape in shapes} == shapes
    for n in (16, 700, 4096, 65536):
        picks = [topk.warps_for(rows, n, 132) for rows in (1, 64, 1024, 4096, 16384, 1 << 20)]
        assert set(picks) <= set(topk.WARPS) and picks == sorted(picks, reverse=True)


def test_price_rows_clamp_ids_into_range(rng):
    """K6 through row ids: every id is clamped into [0, m - 1], the
    sentinel m and larger ids to the last row, negative ids to the first."""
    base = torch.from_numpy(rng.rand(2, 6, 16).astype(np.float32))
    price = torch.from_numpy(rng.rand(2, 16).astype(np.float32))
    rows = torch.tensor([[-1, 6, 2, 9], [0, -7, 5, 6]])
    got = ops.topk_extract_price(base, price, 3, rows)
    want = ops.topk_extract_price(base, price, 3, torch.tensor([[0, 5, 2, 5], [0, 0, 5, 5]]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


class TestKNN:
    @pytest.mark.parametrize("b,n,m,k", [(2, 256, 128, 8), (1, 300, 64, 20), (3, 128, 16, 20)])
    def test_random_matches_fused_kernel(self, rng, b, n, m, k):
        x = rng.rand(b, n, 3).astype(np.float32)
        q = rng.rand(b, m, 3).astype(np.float32)
        gi, gd = ops.knn(_t(x), _t(q), k)
        assert gi.dtype == torch.int32 and gi.shape == (b, m, k)
        ri, rd = knn_fused_pallas(jnp.asarray(x), jnp.asarray(q), k, query_block=m, interpret=True)
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_allclose(_np(rd), gd.numpy(), atol=1e-6)
        xi, xd = jops.knn(jnp.asarray(x), jnp.asarray(q), k)
        np.testing.assert_array_equal(_np(xi), gi.numpy())
        np.testing.assert_allclose(_np(xd), gd.numpy(), atol=1e-6)

    def test_all_equal_cloud(self):
        gi, gd = ops.knn(torch.ones(2, 40, 3), torch.ones(2, 8, 3), 6)
        ri, rd = knn_fused_pallas(jnp.ones((2, 40, 3)), jnp.ones((2, 8, 3)), 6, query_block=8,
                                  interpret=True)
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_array_equal(gi.numpy(), np.broadcast_to(np.arange(6), (2, 8, 6)))
        np.testing.assert_array_equal(gd.numpy(), 0)

    def test_ties_match_jax(self, rng):
        x = _tied_cloud(rng, 2, 160)
        q = _tied_cloud(rng, 2, 32)
        gi, gd = ops.knn(_t(x), _t(q), 20)
        ri, rd = knn_fused_pallas(jnp.asarray(x), jnp.asarray(q), 20, query_block=32, interpret=True)
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_array_equal(_np(rd), gd.numpy())

    def test_wide_points_take_split_path(self, rng):
        x = rng.rand(2, 90, 6).astype(np.float32)
        q = rng.rand(2, 24, 6).astype(np.float32)
        gi, gd = ops.knn(_t(x), _t(q), 5)
        ri, rd = jops.knn(jnp.asarray(x), jnp.asarray(q), 5)
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_allclose(_np(rd), gd.numpy(), atol=1e-5)

    def test_dilated_knn_shuffle(self, rng):
        x = _t(rng.rand(2, 64, 3).astype(np.float32))
        q = _t(rng.rand(2, 16, 3).astype(np.float32))
        plain = ops.knn(x, q, 8)[0]
        np.testing.assert_array_equal(ops.dilated_knn(x, q, 8, 2).numpy(), plain.numpy())
        g = torch.Generator().manual_seed(3)
        shuffled = ops.dilated_knn(x, q, 8, 2, generator=g)
        perm = torch.randperm(8, generator=torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(shuffled.numpy(), plain[..., perm].numpy())

    def test_lanes_rule(self):
        """The kernel's lanes per query on a 132-SM card: 8 at the first SA
        level's k=20 and 4 at the first FP level's k=3 (B=32); a lane's
        share of the list is at most 3 slots, the most the kernel is built
        for; a busier card never gets more lanes."""
        knn = importlib.import_module("patchaugnet_tpu_torch.ops.knn")
        assert knn.lanes_for(32, 4096, 1024, 20, 132) == 8
        assert knn.lanes_for(32, 1024, 4096, 3, 132) == 4
        for k in range(1, 33):
            widths = [knn.lanes_for(b, 1024, 1024, k, 132) for b in (1, 4, 16, 64, 256)]
            assert set(widths) <= set(knn.LANES) and widths == sorted(widths, reverse=True)
            assert max(-(-k // g) for g in widths) <= knn._MAX_SLOTS == 3

    def test_approx_recall_not_ported(self, rng):
        """No approximate kNN is ported: ``approx_recall`` (the TPU's
        ``lax.approx_max_k``, exact on every other backend) runs the exact
        kNN; a target outside (0, 1] raises."""
        x = _t(rng.rand(1, 32, 3).astype(np.float32))
        for got, want in zip(ops.knn(x, x, 4, approx_recall=0.95), ops.knn(x, x, 4)):
            assert torch.equal(got, want)
        with pytest.raises(ValueError, match="approx_recall"):
            ops.knn(x, x, 4, approx_recall=0.0)


class TestTopkExtract:
    @pytest.mark.parametrize("b,m,n,k", [(2, 64, 200, 7), (1, 128, 16, 3), (2, 32, 512, 20)])
    def test_random_matches_kernel(self, rng, b, m, n, k):
        d = rng.rand(b, m, n).astype(np.float32)
        gi, gv = ops.topk_extract(_t(d), k)
        ri, rv = topk_extract_pallas(jnp.asarray(d), k, query_block=m, interpret=True)
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_array_equal(_np(rv), gv.numpy())

    def test_injected_ties(self, rng):
        d = rng.rand(2, 64, 240).astype(np.float32)
        d[:, :, ::13] = d[:, :, 0:1]
        d[:, ::5] = 0.25
        gi, gv = ops.topk_extract(_t(d), 9)
        ri, rv = topk_extract_pallas(jnp.asarray(d), 9, query_block=64, interpret=True)
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_array_equal(_np(rv), gv.numpy())

    def test_input_not_modified(self, rng):
        d = _t(rng.rand(1, 4, 10).astype(np.float32))
        before = d.clone()
        ops.topk_extract(d, 3)
        assert torch.equal(d, before)


class TestGeometry:
    @pytest.mark.parametrize("d", [3, 8])
    def test_pairwise_sqdist(self, rng, d):
        """Bit-equal for d=3; the d=8 expansion differed by 9.5e-7."""
        x = rng.rand(2, 30, d).astype(np.float32)
        y = rng.rand(2, 40, d).astype(np.float32)
        np.testing.assert_allclose(
            _np(jops.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y))),
            ops.pairwise_sqdist(_t(x), _t(y)).numpy(), atol=1e-5,
        )

    def test_three_nn(self, rng):
        u = rng.rand(2, 100, 3).astype(np.float32)
        k = rng.rand(2, 25, 3).astype(np.float32)
        rd, ri = jops.three_nn(jnp.asarray(u), jnp.asarray(k))
        gd, gi = ops.three_nn(_t(u), _t(k))
        assert gi.dtype == torch.int32
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_allclose(_np(rd), gd.numpy(), atol=1e-6)

    @pytest.mark.parametrize("case", ["duplicated", "all_equal", "n3", "n16"])
    def test_three_nn_ties_match_jax(self, rng, case):
        """Tie-heavy 3-NN: duplicated known points on a coarse grid, an
        all-equal cloud, and known clouds of 3 and 16 points (every index
        extracted, or a handful of candidates per query)."""
        n = {"n3": 3, "n16": 16}.get(case, 40)
        if case == "all_equal":
            u, k = np.ones((2, 50, 3), np.float32), np.ones((2, n, 3), np.float32)
        else:
            u, k = _tied_cloud(rng, 2, 50), _tied_cloud(rng, 2, n)
        rd, ri = jops.three_nn(jnp.asarray(u), jnp.asarray(k))
        gd, gi = ops.three_nn(_t(u), _t(k))
        np.testing.assert_array_equal(_np(ri), gi.numpy())
        np.testing.assert_array_equal(_np(rd), gd.numpy())
        # three_nn is knn at k=3, then the square root
        ki, kd = ops.knn(_t(k), _t(u), 3)
        assert torch.equal(gi, ki) and torch.equal(gd, torch.sqrt(kd))

    def test_interpolate_features(self, rng):
        """Max abs difference measured 1.2e-7 (f32 sums in another order)."""
        u = rng.rand(2, 100, 3).astype(np.float32)
        k = rng.rand(2, 25, 3).astype(np.float32)
        f = rng.randn(2, 25, 16).astype(np.float32)
        ref = jops.interpolate_features(jnp.asarray(u), jnp.asarray(k), jnp.asarray(f))
        got = ops.interpolate_features(_t(u), _t(k), _t(f))
        np.testing.assert_allclose(_np(ref), got.numpy(), atol=1e-5)

    def test_query_and_group_edge(self, rng):
        xyz = rng.rand(2, 64, 3).astype(np.float32)
        feats = rng.randn(2, 64, 5).astype(np.float32)
        cidx = rng.choice(64, size=(2, 16)).astype(np.int32)
        new_xyz = np.take_along_axis(xyz, cidx[..., None], 1)
        cfeat = np.take_along_axis(feats, cidx[..., None], 1)
        ref = jops.query_and_group_edge(
            jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats), jnp.asarray(cfeat),
            nsample=8, knn_dilation=2,
        )
        got = ops.query_and_group_edge(_t(xyz), _t(new_xyz), _t(feats), _t(cfeat),
                                       nsample=8, knn_dilation=2)
        np.testing.assert_array_equal(_np(ref.sample_idx), got.sample_idx.numpy())
        np.testing.assert_array_equal(_np(ref.grouped_xyz), got.grouped_xyz.numpy())
        np.testing.assert_array_equal(_np(ref.new_features), got.new_features.numpy())

    def test_gather_group(self, rng):
        f = rng.randn(3, 20, 4).astype(np.float32)
        idx = rng.randint(0, 20, size=(3, 7, 5)).astype(np.int32)
        np.testing.assert_array_equal(
            _np(jops.group(jnp.asarray(f), jnp.asarray(idx))), ops.group(_t(f), _t(idx)).numpy()
        )
        with pytest.raises(TypeError):
            ops.gather(_t(f), _t(idx[..., 0].astype(np.float32)))


class TestContracts:
    def test_checks(self):
        with pytest.raises(ValueError):
            contracts.check_points(torch.zeros(2, 3))
        with pytest.raises(TypeError):
            contracts.check_features(torch.zeros(2, 3, 4, dtype=torch.int32))
        with pytest.raises(ValueError):
            contracts.check_indices(torch.zeros(2, 3, dtype=torch.int32), rank=3)
        with pytest.raises(ValueError):
            contracts.check_same_batch(torch.zeros(2, 3), torch.zeros(3, 3))
        with pytest.raises(ValueError):
            contracts.check_k(5, 4)
        with pytest.raises(ValueError):
            contracts.check_device(torch.zeros(1, device="meta"))


_VLAD_CFG = dict(feature_size=[16, 16, 16], cluster_size=[2, 4, 8], output_dim=[16, 16, 16])
_VLAD_POINTS = [8, 16, 32]


@pytest.mark.parametrize(
    "aggregation_type,gating", [(0, False), (1, False), (2, False), (3, False), (4, False),
                                (5, False), (2, True)]
)
def test_spatial_pyramid_netvlad(rng, aggregation_type, gating):
    """All six aggregation types on carried-over weights and random BN
    statistics; max abs difference measured at most 3.6e-7 (type 0)."""
    feats = [rng.randn(3, n, 16).astype(np.float32) for n in _VLAD_POINTS]
    jm = JSPVLAD(**_VLAD_CFG, max_samples=_VLAD_POINTS, gating=gating,
                 aggregation_type=aggregation_type)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]))
    if "batch_stats" in variables:
        variables["batch_stats"] = random_batch_stats(variables["batch_stats"], rng)
    ref = jm.apply(variables, [jnp.asarray(f) for f in feats], train=False)
    pm = SpatialPyramidNetVLAD(**_VLAD_CFG, gating=gating, aggregation_type=aggregation_type)
    load_jax_variables(pm, variables).eval()
    with torch.inference_mode():
        got = pm([_t(f) for f in feats])
    np.testing.assert_allclose(_np(ref), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("final_activation", [False, True])
def test_mlp(rng, final_activation):
    """Max abs difference measured below 1e-6."""
    x = rng.randn(5, 12).astype(np.float32)
    jm = JMLP([16, 8, 4], final_activation=final_activation)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["batch_stats"] = random_batch_stats(variables["batch_stats"], rng)
    ref = jm.apply(variables, jnp.asarray(x))
    pm = load_jax_variables(MLP(12, [16, 8, 4], final_activation=final_activation), variables).eval()
    with torch.inference_mode():
        np.testing.assert_allclose(_np(ref), pm(_t(x)).numpy(), atol=1e-5)


class TestLoadJaxVariables:
    def _vars(self, rng):
        feats = [rng.randn(2, n, 16).astype(np.float32) for n in _VLAD_POINTS]
        jm = JSPVLAD(**_VLAD_CFG, max_samples=_VLAD_POINTS, aggregation_type=2)
        return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]))

    def test_missing_key_raises(self, rng):
        v = self._vars(rng)
        del v["params"]["vlad0"]["cluster_weights"]
        with pytest.raises(KeyError):
            load_jax_variables(SpatialPyramidNetVLAD(**_VLAD_CFG), v)

    def test_unused_key_raises(self, rng):
        v = self._vars(rng)
        v["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        with pytest.raises(ValueError, match="extra"):
            load_jax_variables(SpatialPyramidNetVLAD(**_VLAD_CFG), v)

    def test_shape_mismatch_raises(self, rng):
        v = self._vars(rng)
        v["params"]["afa"]["fc"]["kernel"] = v["params"]["afa"]["fc"]["kernel"][:-1]
        with pytest.raises(ValueError, match="shape"):
            load_jax_variables(SpatialPyramidNetVLAD(**_VLAD_CFG), v)
