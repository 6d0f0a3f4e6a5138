"""The port's remaining point ops against the JAX package, on the CPU:
``self_sqdist``, ``ball_query``, ``knn_exclude_self``, ``query_and_group``,
``group_all``, every form of ``query_and_group_edge`` and the label
statistics.

The same numpy inputs (b = 2, n = 64-256, seeded) go through the JAX
function and the port. The clouds include exact duplicates and points on
an integer grid, where many distances tie and some lie exactly on the
radius; the radii leave some queries empty, some partly filled and some
over-full (each test checks that its data holds all three). Indices and
counts are exactly equal; so are the squared distances of 3-d points
and the grouped values, which the tests hold bit for bit. The
feature-space ``self_sqdist`` (d = 16, the matrix form, whose sums run in
another order) is held within 1e-5 relative plus 1e-4 absolute (measured
1.1e-5 absolute on distances up to about 60), and the gather's backward
(``featuregather``) within 1e-6 of ``jax.grad``'s scatter-add (measured:
equal).

The JAX oracles compile with XLA's optimisations and the CPU fusion
emitters off (``_jit``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import ops as jops

from patchaugnet_tpu_torch import ops

K = 8


def _jit(fn, **static):
    return jax.jit(fn, static_argnames=tuple(static) or None,
                   compiler_options={"xla_cpu_use_fusion_emitters": False})


@pytest.fixture(autouse=True, scope="module")
def _one_thread_quick_compiles():
    threads = torch.get_num_threads()
    optimise = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimise)
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _clouds(seed, b=2, n=256, m=48):
    """Random points in the unit cube with every 9th point a copy of point
    0 and every 11th a copy of point 5; the queries are 32 of the points
    (so a duplicate is among them), 8 points far outside the cube (empty
    balls) and the rest random."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(b, n, 3).astype(np.float32)
    xyz[:, 9::9] = xyz[:, :1]
    xyz[:, 11::11] = xyz[:, 5:6]
    new_xyz = np.concatenate([xyz[:, :32], rng.rand(b, 8, 3).astype(np.float32) + 3.0,
                              rng.rand(b, m - 40, 3).astype(np.float32)], axis=1)
    return xyz, new_xyz


def _grid(seed, b=2, n=128):
    """Points on a 0..7 integer grid with exact duplicates: distances are
    small integers, so membership at an integer radius and the kNN go
    through exact ties."""
    rng = np.random.RandomState(seed)
    pts = rng.randint(0, 8, size=(b, n, 3)).astype(np.float32)
    pts[:, 1::7] = pts[:, :1]
    return pts


def _fills(xyz, new_xyz, radius):
    """Number of in-ball points per query (numpy, float64)."""
    d = ((new_xyz[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)
    return (d < radius * radius).sum(-1)


def _check_mixed(counts, k):
    assert (counts == 0).any() and ((counts > 0) & (counts < k)).any() and (counts > k).any(), \
        "the data must leave queries empty, partly filled and over-full"


def test_self_sqdist():
    xyz, _ = _clouds(0)
    want = _jit(jops.self_sqdist)(jnp.asarray(xyz))
    got = ops.self_sqdist(_t(xyz))
    _eq(got, want)
    assert (torch.diagonal(got, dim1=-2, dim2=-1) == 0).all()
    feats = np.random.RandomState(1).randn(2, 40, 16).astype(np.float32)
    # the matrix form at d = 16: the sums run in another order
    np.testing.assert_allclose(ops.self_sqdist(_t(feats)).numpy(), np.asarray(jops.self_sqdist(jnp.asarray(feats))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cloud,radius", [("random", 0.2), ("grid", 1.0), ("grid", 1.5)])
def test_ball_query(cloud, radius):
    if cloud == "random":
        xyz, new_xyz = _clouds(2)
    else:
        xyz = _grid(3)
        new_xyz = np.concatenate([xyz[:, :24], xyz[:, :8] + 9.0], axis=1)
    _check_mixed(_fills(xyz, new_xyz, radius), K)
    want = _jit(jops.ball_query, radius=0, k=0)(radius=radius, k=K, xyz=jnp.asarray(xyz),
                                               new_xyz=jnp.asarray(new_xyz))
    got = ops.ball_query(radius, K, _t(xyz), _t(new_xyz))
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("cloud", ["random", "grid"])
def test_knn_exclude_self(cloud):
    xyz = _clouds(4)[0] if cloud == "random" else _grid(5)
    want = _jit(jops.knn_exclude_self, k=0)(jnp.asarray(xyz), None, k=K)
    got = ops.knn_exclude_self(_t(xyz), None, K)
    _eq(got, want)
    want = _jit(jops.knn_exclude_self, k=0)(jnp.asarray(xyz), jnp.asarray(xyz[:, :20]), k=3)
    _eq(ops.knn_exclude_self(_t(xyz), _t(xyz[:, :20]), 3), want)


def _edge_inputs(seed):
    xyz, new_xyz = _clouds(seed, n=128, m=48)
    rng = np.random.RandomState(seed + 100)
    feats = rng.randn(2, 128, 5).astype(np.float32)
    cfeat = rng.randn(2, 48, 5).astype(np.float32)
    return xyz, new_xyz, feats, cfeat


EDGE_FORMS = {
    "radius": dict(radius=0.25),
    "radius no xyz": dict(radius=0.25, use_xyz=False),
    "idx": dict(idx=True),
    "xyz only": dict(features=None),
    "xyz only radius": dict(features=None, radius=0.25),
    "knn no xyz": dict(use_xyz=False),
    "self query": dict(new_xyz=None, center_features=None, nsample=1),
}


@pytest.mark.parametrize("form", list(EDGE_FORMS))
def test_query_and_group_edge_forms(form):
    xyz, new_xyz, feats, cfeat = _edge_inputs(6)
    kw = dict(EDGE_FORMS[form])
    nsample = kw.pop("nsample", K)
    args = {"new_xyz": new_xyz, "features": feats, "center_features": cfeat}
    if "radius" in kw:
        _check_mixed(_fills(xyz, new_xyz, kw["radius"]), nsample)
    for name in ("new_xyz", "features", "center_features"):
        if name in kw:
            args[name] = kw.pop(name)
    if kw.pop("idx", False):
        kw["idx"] = np.random.RandomState(7).randint(0, 128, size=(2, 48, nsample)).astype(np.int32)
    if args["new_xyz"] is None:
        args["features"], args["center_features"] = feats, feats
    jargs = {k: None if v is None else jnp.asarray(v) for k, v in args.items()}
    targs = {k: None if v is None else _t(v) for k, v in args.items()}
    jkw = {k: jnp.asarray(v) if k == "idx" else v for k, v in kw.items()}
    tkw = {k: _t(v) if k == "idx" else v for k, v in kw.items()}
    want = jops.query_and_group_edge(jnp.asarray(xyz), jargs["new_xyz"], jargs["features"],
                                     jargs["center_features"], nsample=nsample, **jkw)
    got = ops.query_and_group_edge(_t(xyz), targs["new_xyz"], targs["features"], targs["center_features"],
                                   nsample=nsample, **tkw)
    _eq(got.sample_idx, want.sample_idx)
    _eq(got.grouped_xyz, want.grouped_xyz)
    _eq(got.new_features, want.new_features)


def test_query_and_group_edge_shuffle():
    """At ``knn_dilation > 1`` with a generator the k neighbours come in a
    random order (JAX: a ``key``). A JAX permutation cannot be drawn from a
    torch generator, so this holds the set of indices per row, the
    neighbour max-pool (the consumer, permutation invariant) and the
    determinism of a seeded generator."""
    xyz, new_xyz, feats, cfeat = _edge_inputs(8)
    want = jops.query_and_group_edge(jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(feats), jnp.asarray(cfeat),
                                     nsample=K, knn_dilation=2, key=jax.random.PRNGKey(0))
    runs = [ops.query_and_group_edge(_t(xyz), _t(new_xyz), _t(feats), _t(cfeat), nsample=K, knn_dilation=2,
                                     generator=torch.Generator().manual_seed(seed)) for seed in (1, 1, 2)]
    _eq(runs[0].sample_idx, runs[1].sample_idx)
    assert not torch.equal(runs[0].sample_idx, runs[2].sample_idx)
    plain = ops.query_and_group_edge(_t(xyz), _t(new_xyz), _t(feats), _t(cfeat), nsample=K, knn_dilation=2)
    assert not torch.equal(runs[0].sample_idx, plain.sample_idx)
    for got in runs:
        _eq(got.sample_idx.sort(dim=-1).values, np.sort(np.asarray(want.sample_idx), axis=-1))
        _eq(got.new_features.amax(dim=2), np.asarray(want.new_features).max(axis=2))


QG_FORMS = {
    "knn": dict(),
    "radius": dict(radius=0.25),
    "radius no xyz": dict(radius=0.25, use_xyz=False),
    "idx": dict(idx=True),
    "xyz only": dict(features=None),
}


@pytest.mark.parametrize("form", list(QG_FORMS))
def test_query_and_group(form):
    xyz, new_xyz, feats, _ = _edge_inputs(9)
    kw = dict(QG_FORMS[form])
    f = kw.pop("features", feats)
    if kw.pop("idx", False):
        kw["idx"] = np.random.RandomState(10).randint(0, 128, size=(2, 48, K)).astype(np.int32)
    want = jops.query_and_group(jnp.asarray(xyz), jnp.asarray(new_xyz), None if f is None else jnp.asarray(f),
                                nsample=K, **{k: jnp.asarray(v) if k == "idx" else v for k, v in kw.items()})
    got = ops.query_and_group(_t(xyz), _t(new_xyz), None if f is None else _t(f), nsample=K,
                              **{k: _t(v) if k == "idx" else v for k, v in kw.items()})
    _eq(got, want)


@pytest.mark.parametrize("use_xyz,with_features", [(True, True), (False, True), (True, False)])
def test_group_all(use_xyz, with_features):
    xyz, _, feats, _ = _edge_inputs(11)
    f = feats if with_features else None
    want = jops.group_all(jnp.asarray(xyz), None if f is None else jnp.asarray(f), use_xyz=use_xyz)
    _eq(ops.group_all(_t(xyz), None if f is None else _t(f), use_xyz=use_xyz), want)


@pytest.mark.parametrize("cloud,radius", [("random", 0.2), ("grid", 1.5)])
def test_labelstat(cloud, radius):
    rng = np.random.RandomState(12)
    if cloud == "random":
        xyz, new_xyz = _clouds(13)
    else:
        xyz = _grid(14)
        new_xyz = np.concatenate([xyz[:, :24], xyz[:, :8] + 9.0], axis=1)
    _check_mixed(_fills(xyz, new_xyz, radius), K)
    label = rng.randint(0, 5, size=xyz.shape[:2] + (13,)).astype(np.int32)
    jx, jq, jl = jnp.asarray(xyz), jnp.asarray(new_xyz), jnp.asarray(label)
    stat, idx = ops.labelstat_and_ballquery(radius, K, _t(xyz), _t(new_xyz), _t(label))
    want_stat, want_idx = jops.labelstat_and_ballquery(radius, K, jx, jq, jl)
    assert stat.dtype == torch.int32 and idx.dtype == torch.int32
    _eq(stat, want_stat)
    _eq(idx, want_idx)
    _eq(ops.labelstat_ballrange(radius, _t(xyz), _t(new_xyz), _t(label)), want_stat)
    got = ops.labelstat_idx(_t(label), idx)
    assert got.dtype == torch.int32
    _eq(got, jops.labelstat_idx(jl, want_idx))


def test_featuredistribute_ties_and_featuregather():
    """On the grid many candidates tie for the nearest: the first index
    wins on both sides. ``featuregather``'s backward is the gather's
    scatter-add, held against ``jax.grad``."""
    max_xyz = _grid(15, n=64)
    xyz = _grid(16, n=96) + np.float32(0.5) * (np.arange(96) % 2)[None, :, None].astype(np.float32)
    want = jops.featuredistribute(jnp.asarray(max_xyz), jnp.asarray(xyz))
    got = ops.featuredistribute(_t(max_xyz), _t(xyz))
    assert got.dtype == torch.int32
    _eq(got, want)
    d = ((xyz[:, :, None] - max_xyz[:, None]) ** 2).sum(-1)
    assert ((d == d.min(-1, keepdims=True)).sum(-1) > 1).any(), "the data must hold tied candidates"

    rng = np.random.RandomState(17)
    feat = rng.randn(2, 64, 6).astype(np.float32)
    weight = rng.randn(2, 96, 6).astype(np.float32)
    t_feat = _t(feat).requires_grad_(True)
    out = ops.featuregather(t_feat, got)
    (out * _t(weight)).sum().backward()
    jfeat = jnp.asarray(feat)
    _eq(out, jops.featuregather(jfeat, want))
    jgrad = jax.grad(lambda f: jnp.sum(jops.featuregather(f, want) * jnp.asarray(weight)))(jfeat)
    np.testing.assert_allclose(t_feat.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)
