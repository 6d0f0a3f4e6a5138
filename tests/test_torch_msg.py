"""The port's multi-scale set abstraction against the JAX package's.

A JAX ``PointNet2SAModuleMSG`` is initialised on the CPU, its BN
statistics replaced by random numpy values, and its variables carried
into the port's ``PointNet2SAModuleMSG`` with ``load_jax_variables``
(the scales' MLPs are ``mlp{i}`` on both sides); both take the same numpy
points and features. Sample indices are exactly equal; features within
1e-5 (measured 3.6e-7 in eval mode, 6.0e-6 in train mode, where the
batch statistics come from 16 x 8 rows), new BatchNorm statistics within
1e-5 relative.
Also: a single-scale MSG equals the port's ``PointNet2SAModule`` on the
same weights, and ``ops.gather`` raises on an index outside its table,
where the JAX ``gather`` clamps it.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import ops as jops
from patchaugnet_tpu.models.backbone import PointNet2SAModuleMSG as JaxMSG

from patchaugnet_tpu_torch import ops
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.models import MSGLevelOutput, PointNet2SAModuleMSG
from patchaugnet_tpu_torch.models.backbone import PointNet2SAModule
from patchaugnet_tpu_torch.nn import seeded_init_

N, C, NPOINT = 64, 8, 16
FEAT_TOL = 1e-5
STATS_RTOL = 1e-5
# (nsamples, mlps, radii, knn_dilation, use_xyz): two kNN scales and a
# ball scale (radius 0.3 holds about 7 of the 64 points: some balls short,
# some over-full), with and without dilation and xyz
CASES = {
    "knn_knn_ball": ((4, 8, 8), ((16, 16), (16, 32), (8, 24)), (None, None, 0.3), 1, True),
    "dilated": ((4, 8, 8), ((16, 16), (16, 32), (8, 24)), (None, None, 0.3), 2, True),
    "without_xyz": ((6, 8), ((16,), (8, 12)), (0.25, None), 1, False),
}


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_cpu_use_fusion_emitters": False})


@pytest.fixture(autouse=True, scope="module")
def _one_thread_quick_compiles():
    """One intra-op thread (the tensors are small, and a thread pool per
    test process spins against the other pytest workers), and the JAX
    oracles compiled with XLA's optimisations off (they compile in a
    fraction of the time)."""
    threads = torch.get_num_threads()
    optimise = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimise)
    torch.set_num_threads(threads)


def _random_batch_stats(tree, rng):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _random_batch_stats(val, rng)
        elif key == "var":
            out[key] = (rng.rand(*val.shape) + 0.5).astype(np.float32)
        else:
            out[key] = (rng.randn(*val.shape) * 0.2).astype(np.float32)
    return out


def _inputs(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return rng.rand(b, N, 3).astype(np.float32), rng.rand(b, N, C).astype(np.float32), rng


def _stats(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _stats(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_msg_matches_jax(case, train):
    """Centres, new xyz and the concatenated sample indices equal; features
    within FEAT_TOL; in train mode the new running statistics within
    STATS_RTOL."""
    nsamples, mlps, radii, dilation, use_xyz = CASES[case]
    xyz, feats, rng = _inputs()
    jm = JaxMSG(npoint=NPOINT, nsamples=nsamples, mlps=mlps, radii=radii, knn_dilation=dilation, use_xyz=use_xyz)
    variables = jax.tree.map(np.asarray, _jit(jm.init)(jax.random.PRNGKey(0), xyz, feats))
    variables = {"params": variables["params"], "batch_stats": _random_batch_stats(variables["batch_stats"], rng)}
    if train:
        want, new = _jit(lambda v, x, f: jm.apply(v, x, f, train=True, mutable=["batch_stats"]))(
            variables, xyz, feats)
    else:
        want = _jit(lambda v, x, f: jm.apply(v, x, f, train=False))(variables, xyz, feats)
    model = PointNet2SAModuleMSG(NPOINT, nsamples, C, mlps, radii=radii, knn_dilation=dilation, use_xyz=use_xyz)
    model = load_jax_variables(model, variables).train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert isinstance(got, MSGLevelOutput)
    for name in ("center_idx", "sample_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.new_xyz.numpy(), np.asarray(want.new_xyz))
    assert got.sample_idx.shape == (2, NPOINT, sum(nsamples))
    assert got.features.shape == (2, NPOINT, sum(m[-1] for m in mlps))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), rtol=0, atol=FEAT_TOL)
    if train:
        mine = dict(model.named_buffers())
        for path, val in _stats(new["batch_stats"]):
            name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean" else ".running_var")
            np.testing.assert_allclose(mine[name].numpy(), val, rtol=STATS_RTOL, atol=1e-7, err_msg=name)


def test_single_scale_msg_equals_the_sa_module():
    """One kNN scale on the SA module's weights: the same outputs bit for bit."""
    xyz, feats, _ = _inputs(1)
    sa = seeded_init_(PointNet2SAModule(NPOINT, 4, C, (16, 16), knn_dilation=2), torch.Generator().manual_seed(0))
    msg = PointNet2SAModuleMSG(NPOINT, (4,), C, ((16, 16),), knn_dilation=2)
    msg.mlp0.load_state_dict(sa.mlp.state_dict())
    for mode in (False, True):
        sa.train(mode), msg.train(mode)
        want = sa(torch.from_numpy(xyz), torch.from_numpy(feats))
        got = msg(torch.from_numpy(xyz), torch.from_numpy(feats))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_bf16_msg_keeps_the_f32_indices():
    """At a bf16 compute dtype every index is the f32 path's; the features
    come back bf16, near the f32 ones."""
    nsamples, mlps, radii, dilation, use_xyz = CASES["knn_knn_ball"]
    xyz, feats, _ = _inputs(2)
    f32 = seeded_init_(PointNet2SAModuleMSG(NPOINT, nsamples, C, mlps, radii=radii),
                       torch.Generator().manual_seed(0)).eval()
    bf16 = PointNet2SAModuleMSG(NPOINT, nsamples, C, mlps, radii=radii, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        want = f32(torch.from_numpy(xyz), torch.from_numpy(feats))
        got = bf16(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert torch.equal(got.sample_idx, want.sample_idx) and torch.equal(got.center_idx, want.center_idx)
    assert got.features.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(got.features.float().flatten(1), want.features.flatten(1))
    assert float(cos.min()) > 0.999


def test_msg_rejects_mismatched_scales():
    with pytest.raises(ValueError, match="nsamples"):
        PointNet2SAModuleMSG(NPOINT, (4, 8), C, ((16,),))
    with pytest.raises(ValueError, match="radii"):
        PointNet2SAModuleMSG(NPOINT, (4,), C, ((16,),), radii=(0.1, 0.2))


@pytest.mark.parametrize("where", ["last_cloud_past_n", "first_cloud_negative"])
def test_gather_raises_outside_its_table(where):
    """The JAX ``gather`` clamps an index outside the flat table (and under
    ``PCR_DEBUG`` poisons its row with NaN); the port's ``index_select``
    raises. An index outside [0, n) that stays inside the flat table reads
    the neighbouring cloud's row on both sides: callers pass in-range
    indices (every grouper of the MSG path does)."""
    feats = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    idx = torch.zeros(2, 4, dtype=torch.int32)
    if where == "last_cloud_past_n":
        idx[1, 2] = 5
    else:
        idx[0, 1] = -1
    jax_out = np.asarray(_jit(jops.gather)(jnp.asarray(feats.numpy()), jnp.asarray(idx.numpy())))
    assert np.isfinite(jax_out).all()                      # clamped, no error
    with pytest.raises(IndexError):
        ops.gather(feats, idx)
    inside = torch.zeros(2, 4, dtype=torch.int32)
    inside[0, 3] = 5                                       # row 0 of the second cloud
    assert torch.equal(ops.gather(feats, inside)[0, 3], feats[1, 0])
