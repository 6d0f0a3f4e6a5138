"""The port's parallel layer against the JAX package, on the CPU.

One gloo world of two ranks (and one of four for the 2 x 2 mesh) is
spawned per module and computes every case in one go
(``tests/torch_parallel_worker.py``); the parent holds the results against
the JAX functions on the conftest's virtual 8-device mesh and against the
port's single-process functions, on the same numpy inputs and weights.
The sizes are those of ``tests/test_train.py::TestParallel``.

Indices from point-axis sharding equal the JAX ones exactly. Tolerances:
- the data-parallel step against JAX's ``build_parallel_train_step`` on a
  mesh of two and against the port's single-process step: the total
  within rtol 1e-5, the updated parameters and statistics within atol
  1e-5 (the BatchNorm statistics are averaged over the ranks, so their
  sums run in another order);
- the data-parallel gradients against the single-process ones: leaf by
  leaf within GRAD_RTOL in relative L2 (``_leaf_errors``), their norm
  within 1% of the single-process norm: not twice it;
- the sharded eval forwards and the point-sharded features: the bits of
  the single-process forward where the computation per row is the same
  (global and local descriptors of each record, every FP feature), the
  descriptors of the point-sharded forwards within 1e-6 (the finest VLAD
  scale sums in another order), and within DESC_TOL of the JAX model;
- the point-sharded train steps of PatchAugNet and PPT-Net against the
  port's single-process step (the JAX single-device step's port, held to
  it in ``tests/test_torch_train.py``): the loss within rtol 1e-5, the
  parameters within atol 1e-5, and PPT-Net's gradients leaf by leaf
  within GRAD_RTOL.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchaugnet_tpu import ops as jops
from patchaugnet_tpu import parallel as jparallel
from patchaugnet_tpu import train as jtrain
from patchaugnet_tpu.losses.patch_contrast import PatchCorrespondences as JaxCorrespondences
from patchaugnet_tpu.models import get_model as jax_get_model
from patchaugnet_tpu.parallel import host_data as jhost_data

from patchaugnet_tpu_torch import configs, data, models, ops, parallel, serving, train
from patchaugnet_tpu_torch.data import retrieval
from patchaugnet_tpu_torch.compat import load_jax_variables, to_jax_variables
from patchaugnet_tpu_torch.losses import PatchCorrespondences

import torch_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(configs.PATCH_AUG_NET_TRAIN, NUM_POINTS=128, SAMPLING=[32, 8, 4], KNN=[8, 8, 4],
           MAX_SAMPLES=[8, 32, 128], FEATURE_SIZE=[64] * 3, OUTPUT_DIM=[64] * 3, TRAIN_BATCH_SIZE=2,
           TRAIN_POSITIVES_PER_QUERY=1, TRAIN_NEGATIVES_PER_QUERY=2, BASE_LEARNING_RATE=1e-4, MAX_EPOCH=2,
           A2B_MAX_ROWS=64, A2B_MAX_PAIRS=4, OPTIMIZER="momentum")
TOTAL = 2 * (1 + 1 + 2 + 1)
# the patch branch on the first three of the queries and positives: rows 0
# and 1 on rank 0, row 5 on rank 1
CFG_A2A = dict(CFG, A2A_MAX_CLOUDS=3)
PLAIN_CFG = dict(CFG, use_patch_recon=False, use_patch_feature_contrast=False)
PPT_CFG = dict(configs.PPTNET_ORIGIN, NUM_POINTS=128, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4],
               FEATURE_SIZE=[32] * 4, OUTPUT_DIM=[32] * 4, CLUSTER_SIZE=[1, 2, 4, 8], MAX_SAMPLES=[8, 16, 32, 128],
               GROUP=8)
PPT_STEP_CFG = dict(PPT_CFG, model_type="pptnet_l2_norm", TRAIN_BATCH_SIZE=2, TRAIN_POSITIVES_PER_QUERY=1,
                    TRAIN_NEGATIVES_PER_QUERY=2, BASE_LEARNING_RATE=1e-4, OPTIMIZER="momentum")
PNV_CFG = dict(configs.POINTNET_VLAD, NUM_POINTS=64, FEATURE_OUTPUT_DIM=32)
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-5
GRAD_RTOL = 1e-2
DESC_TOL = 1e-4


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_cpu_use_fusion_emitters": False})


@functools.lru_cache(maxsize=None)
def _jax_eval(family):
    """The JAX model's jitted eval forward, compiled once per family and shape."""
    model = jax_get_model(family, {"patch_aug_net": CFG, "pointnet_vlad": PNV_CFG}[family])
    return _jit(lambda v, x: model.apply(v, x))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_quick_compiles():
    threads = torch.get_num_threads()
    optimise = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimise)
    torch.set_num_threads(threads)


def _random_variables(tree, rng):
    """Kernels normal with std 1/sqrt(fan_in), scales and running
    variances uniform in [0.5, 1.5], biases and running means normal."""
    def fill(key, leaf):
        shape = tuple(leaf.shape)
        if key in ("scale", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if key in ("bias", "mean"):
            return (rng.randn(*shape) * (0.2 if key == "mean" else 0.1)).astype(np.float32)
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    return {k: _random_variables(v, rng) if hasattr(v, "items") else fill(k, v) for k, v in tree.items()}


def _tables(rng):
    """Correspondence tables over the flat batch (as tests/test_torch_train.py):
    pairs between query 0 and positive 1 and between query 5 and positive 6."""
    t = CFG["A2B_MAX_ROWS"]
    pair = rng.randint(0, 3, t).astype(np.int32)
    q_cloud = np.where(pair == 1, 5, 0).astype(np.int32)
    n_cloud = q_cloud + 1
    valid = (rng.rand(t) < 0.5) & (pair != 2)
    m = CFG["SAMPLING"][0]
    slots = [rng.randint(0, m, t).astype(np.int32) for _ in range(3)]
    return (q_cloud, n_cloud, *slots, pair, valid)


def _port_model(cfg, variables, model_type=None):
    return load_jax_variables(models.get_model(model_type or cfg["model_type"], cfg), variables)


def _without(tree, name):
    return {col: {k: v for k, v in sub.items() if k != name} for col, sub in tree.items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    variables = _random_variables(to_jax_variables(models.get_model("patch_aug_net", CFG)), rng)
    mask = np.zeros(TOTAL, bool)
    mask[[0, 1, 5, 6]] = True                                 # queries and positives
    return dict(
        cfg=CFG, cfg_a2a=CFG_A2A, plain_cfg=PLAIN_CFG, sharded_cfg=PLAIN_CFG, variables=variables,
        variables_nodec=_without(variables, "decoder"),
        clouds=rng.rand(TOTAL, CFG["NUM_POINTS"], 3).astype(np.float32), mask=mask, tables=_tables(rng),
        bn_x=rng.randn(6, 5, 16).astype(np.float32),
        records=rng.rand(8, CFG["NUM_POINTS"], 3).astype(np.float32),
        xyz=rng.rand(2, 256, 3).astype(np.float32), q=rng.rand(2, 64, 3).astype(np.float32),
        f=rng.randn(2, 256, 8).astype(np.float32), gidx=rng.randint(0, 256, (2, 32, 10)).astype(np.int32),
        queries=rng.randn(20, 16).astype(np.float32), db=rng.randn(128, 16).astype(np.float32),
        ppt_cfg=PPT_CFG, ppt_step_cfg=PPT_STEP_CFG, ppt_clouds=rng.rand(2, 128, 3).astype(np.float32),
        ppt_variables=_random_variables(to_jax_variables(models.get_model("pptnet_l2_norm", PPT_CFG)), rng),
        pnv_cfg=PNV_CFG, pnv_clouds=rng.rand(2, 64, 3).astype(np.float32),
        pnv_variables=_random_variables(to_jax_variables(models.get_model("pointnet_vlad", PNV_CFG)), rng),
        sa=dict(npoint=16, nsample=16, c=8, widths=(16, 32), xyz=rng.rand(2, 256, 3).astype(np.float32),
                feats=rng.randn(2, 256, 8).astype(np.float32),
                variables=_random_variables(to_jax_variables(models.backbone.PointNet2SAModule(16, 16, 8, (16, 32))),
                                            rng)),
    )


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank's results of the four-rank world."""
    return parallel.spawn(worker.world, 4, args=(inputs,), platform="cpu")


@pytest.fixture(scope="module")
def two(ranks):
    """The results of the mesh of ranks 0 and 1."""
    return ranks[:2]


_SINGLE = {}


def _single_step(cfg, inputs):
    """The port's single-process step from the same variables, batch and
    tables (computed once per config)."""
    patches = cfg.get("use_patch_recon", False)
    key = (patches, cfg.get("A2A_MAX_CLOUDS"))
    if key not in _SINGLE:
        variables = inputs["variables"] if patches else inputs["variables_nodec"]
        state = train.create_train_state(_port_model(cfg, variables), cfg, steps_per_epoch=1, device="cpu")
        corr = PatchCorrespondences(*(torch.from_numpy(a) for a in inputs["tables"]), cfg["A2B_MAX_PAIRS"])
        _SINGLE[key] = train.build_train_step(state.model, cfg)(state, inputs["clouds"], corr, inputs["mask"])
    return _SINGLE[key]


def _tree_of(params, cfg, model_type=None):
    model = models.get_model(model_type or cfg["model_type"], cfg)
    model.load_state_dict(params)
    return to_jax_variables(model)


def _assert_trees_close(got, want, atol, skip=lambda path: False):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        if not skip(path):
            np.testing.assert_allclose(leaf, np.asarray(flat_want[path]), atol=atol, err_msg=str(path))


def SA_PARAMS(path):
    """The SA levels' parameters: their gradients differ between the port
    and JAX as much as JAX's own jitted and eager gradients do (the
    max-pools over near-tied neighbours route by the order of the sums;
    ``tests/test_torch_train.py::test_loss_gradients_match_jax``), so after
    one update at lr 1e-3 they lay up to 5.0e-3 from JAX's."""
    keys = [getattr(k, "key", None) for k in path]
    return keys[0] == "params" and keys[1] in ("sa0", "sa1", "sa2")


@pytest.fixture(scope="module")
def jax_parallel_step(inputs):
    """JAX's data-parallel step on a mesh of two virtual devices, from the
    same variables and batch, without the patch branch: compiled as this
    suite compiles its oracles (XLA's optimisations off), the step with the
    patch branch returns NaN parameters on this batch, and with them on it
    compiles in 23 s on one core, half this file's budget."""
    cfg = PLAIN_CFG
    model = jax_get_model("patch_aug_net", cfg)
    schedule = jtrain.state.make_schedule(cfg["LEARNING_RATE_DECAY"], cfg["BASE_LEARNING_RATE"], 1, cfg["MAX_EPOCH"])
    tx = jtrain.state.make_optimizer(cfg["OPTIMIZER"], schedule, cfg["MOMENTUM"])
    # the step donates its state: hand it copies, never buffers over the numpy inputs
    params = jax.tree.map(jnp.array, inputs["variables_nodec"]["params"])
    state = jtrain.state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    batch_stats=jax.tree.map(jnp.array, inputs["variables_nodec"]["batch_stats"]),
                                    opt_state=tx.init(params), tx=tx)
    mesh = jparallel.make_mesh(2)
    corr = JaxCorrespondences(*(jnp.asarray(a) for a in inputs["tables"]), cfg["A2B_MAX_PAIRS"])
    args = (state, jparallel.shard_batch(mesh, inputs["clouds"]), corr, jparallel.shard_batch(mesh, inputs["mask"]))
    # the package's jitted step, compiled without XLA's CPU fusion emitters
    step = jparallel.build_parallel_train_step(model, cfg, mesh).lower(*args).compile(
        {"xla_cpu_use_fusion_emitters": False})
    state, metrics = step(*args)
    return jax.tree.map(np.asarray, state.variables), {k: float(v) for k, v in metrics.items()}


def test_parallel_step_matches_jax_and_single_process(two, inputs, jax_parallel_step):
    """The data-parallel step over two ranks: the JAX parallel step's total
    and updated statistics and parameters (the SA levels' parameters
    excepted, see ``SA_PARAMS``; measured 3.0e-6 at most elsewhere), and
    the port's single-process step's total and every updated variable;
    every rank ends with the same parameters, statistics and gradients."""
    jax_vars, jax_metrics = jax_parallel_step
    single, single_metrics = _single_step(PLAIN_CFG, inputs)
    got = two[0]["step"]
    assert got["metrics"]["total"] > 1e-3
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, jax_metrics[k], rtol=STEP_RTOL, err_msg=k)
        np.testing.assert_allclose(v, float(single_metrics[k]), rtol=STEP_RTOL, err_msg=k)
    _assert_trees_close(_tree_of(got["params"], PLAIN_CFG), jax_vars, PARAM_ATOL, skip=SA_PARAMS)
    for k, v in single.model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    assert all(rank["step"]["ranks_agree"] for rank in two)
    assert got["metrics"] == two[1]["step"]["metrics"]


def test_parallel_gradients_are_the_single_process_ones(two, inputs):
    """After the step (with the patch branch, its rows from both ranks)
    each rank holds the single-process gradients, not twice them: every
    rank computes the loss on the gathered batch, so the backward gives
    each rank twice its share, and the step averages over the ranks. Leaf
    by leaf in relative L2 within GRAD_RTOL (measured 1.1e-3; this model's
    gradients move with the order of its sums through near-tied
    max-pools), a leaf's norm floored at 1e-4 of the largest (the biases
    before a BatchNorm have rounding-noise gradients), and the whole
    gradient's norm within 1% of the single-process one."""
    single, _ = _single_step(CFG_A2A, inputs)
    want = {k: p.grad.double() for k, p in single.model.named_parameters()}
    got = {k: g.double() for k, g in two[0]["step_a2a"]["grads"].items()}
    for k, err in _leaf_errors(got, want).items():
        assert err < GRAD_RTOL, f"{k}: relative L2 {err:.3e}"
    norm = lambda grads: float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    assert abs(norm(got) / norm(want) - 1.0) < 0.01


def test_parallel_step_patch_rows_cross_ranks(two, inputs):
    """A2A_MAX_CLOUDS=3 below B x (1 + P) = 4: the patch branch takes rows
    0 and 1 from rank 0 and row 5 from rank 1 (``_first_true`` over the
    whole batch's mask); the step is the single-process step at the same
    setting, and every rank ends the same."""
    sel = train.step._first_true(torch.from_numpy(inputs["mask"]), CFG_A2A["A2A_MAX_CLOUDS"])
    assert sel.tolist() == [0, 1, 5]
    single, single_metrics = _single_step(CFG_A2A, inputs)
    got = two[0]["step_a2a"]
    assert set(got["metrics"]) == {"place_recognition", "patch_recon_a2a", "patch_recon_a2b", "total"}
    assert got["metrics"]["patch_recon_a2a"] > 0.0 and got["metrics"]["patch_recon_a2b"] > 0.0
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, float(single_metrics[k]), rtol=STEP_RTOL, err_msg=k)
    for k, v in single.model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    assert all(rank["step_a2a"]["ranks_agree"] for rank in two)


def test_sharded_forward_and_local_forward(two, inputs):
    """Records split over the ranks, outputs gathered back: every rank
    holds the single-process forwards' outputs, bit for bit, and the JAX
    model's descriptors within tolerance."""
    model = _port_model(CFG_A2A, inputs["variables"])
    want = serving.build_forward_fn(model, "cpu")(inputs["records"])
    want_local = serving.build_local_forward_fn(model, "cpu")(inputs["records"])
    for rank in two:
        assert torch.equal(rank["forward"], want)
        for got, ref in zip(rank["local_forward"], want_local):
            assert torch.equal(got, ref)
    ref = _jax_eval("patch_aug_net")(inputs["variables"], jnp.asarray(inputs["records"]))
    np.testing.assert_allclose(two[0]["forward"].numpy(), np.asarray(ref.global_desc), atol=DESC_TOL)


def test_host_batch_slice(ranks):
    """Each rank's slice of a batch: by the process group's rank and size
    by default, and the JAX host slices for every simulated host count."""
    assert [r["default_slice"] for r in ranks] == [slice(3 * i, 3 * i + 3) for i in range(4)]
    assert [r["host_slice"] for r in ranks[:2]] == [slice(0, 5), slice(5, 10)]
    for count in (1, 2, 4):
        for index in range(count):
            assert parallel.host_batch_slice(64, index, count) == jhost_data.host_batch_slice(64, index, count)
            assert parallel.host_record_indices(list(range(64)), index, count) == \
                jhost_data.host_record_indices(list(range(64)), index, count)
    with pytest.raises(ValueError, match="split evenly"):
        parallel.host_batch_slice(10, 0, 4)


def _entries(nn_dict):
    return {k: [(e.idx1, e.near_indices2, e.far_indices2, e.bad_far_indices2) for e in v] for k, v in nn_dict.items()}


def test_a_rank_loads_only_its_rows():
    """A data-parallel rank's batch (``rows``): the whole batch's draws,
    tuples and overlap tables, and only its rows of the clouds, those of
    the whole batch; a rank's rows of each batch of a descriptor sweep
    (the mining refresh): the padded batch's rows, the sharded forward's
    whole-batch outputs kept. Augmentation, and a store without the whole
    clouds, are refused."""
    kw = dict(num_pos=1, num_neg=2, num_points=64, device="cpu", load_overlap_indices=True)
    whole = data.PlaceRecognitionDataset("synthetic", True, **kw)
    batch = next(whole.iter_epoch(2))
    for rows in (slice(0, 5), slice(5, 10)):
        part = next(data.PlaceRecognitionDataset("synthetic", True, **kw).iter_epoch(2, rows=rows))
        assert part.total == batch.total == 10 and part.rows == rows and batch.rows is None
        np.testing.assert_array_equal(part.clouds, batch.clouds[rows])
        assert part.query_indices == batch.query_indices and _entries(part.nn_dict) == _entries(batch.nn_dict)
    scene, size = whole.scene, 20
    n = len(scene.records)
    seen, outs = [], []

    def forward(clouds):
        seen.append(clouds)
        outs.append(np.random.RandomState(len(outs)).rand(size, 4).astype(np.float32))
        return outs[-1]

    scene.make_descs(forward, size, rows=slice(10, 20))
    starts = range(0, n, size)
    assert len(seen) == len(starts) and n % size
    for s, clouds in zip(starts, seen):
        idx = list(range(s, min(s + size, n)))
        padded = idx + idx[-1:] * (size - len(idx))
        np.testing.assert_array_equal(clouds, scene.get_clouds(padded[10:20])[0])
    np.testing.assert_array_equal(scene.global_descs, np.concatenate(outs)[:n])
    with pytest.raises(ValueError, match="whole"):
        scene.make_descs(forward, size, save_model_type="x", rows=slice(0, 10))
    with pytest.raises(ValueError, match="augmentation"):
        data.PlaceRecognitionDataset("synthetic", True, augmentation=["jitter"], **kw).sample_batch([0, 1], slice(0, 5))


def test_sharded_knn_fps_group_match_jax(two, inputs):
    """sharded_knn, sharded_fps and sharded_group over two point shards:
    the JAX ops' indices and rows on the whole cloud exactly (the JAX
    sharded ops equal them, ``tests/test_train.py::TestShardedOps``), and
    the single-process ops' distances and rows bit for bit; the sharded
    retrieval is ``data.retrieval.topk_neighbors``'s."""
    x, q = jnp.asarray(inputs["xyz"]), jnp.asarray(inputs["q"])
    ref_i = np.asarray(jops.knn(x, q, 10)[0])
    ref_f = np.asarray(jops.farthest_point_sample(x, 64))
    ref_g = np.asarray(jops.group(jnp.asarray(inputs["f"]), jnp.asarray(inputs["gidx"])))
    xyz, qt = torch.from_numpy(inputs["xyz"]), torch.from_numpy(inputs["q"])
    plain_i, plain_d = ops.knn(xyz, qt, 10)
    plain_g = ops.group(torch.from_numpy(inputs["f"]), torch.from_numpy(inputs["gidx"]))
    want_d, want_i = retrieval.topk_neighbors(inputs["queries"], inputs["db"], 7, device="cpu")
    for rank in two:
        idx, d2 = rank["knn"]
        np.testing.assert_array_equal(idx.numpy(), ref_i)
        assert torch.equal(idx, plain_i) and torch.equal(d2, plain_d)
        np.testing.assert_array_equal(rank["fps"].numpy(), ref_f)
        assert torch.equal(rank["group"], plain_g)
        np.testing.assert_array_equal(rank["group"].numpy(), ref_g)
        d, i = rank["retrieval"]
        np.testing.assert_array_equal(i.numpy(), want_i)
        np.testing.assert_allclose(d.numpy(), want_d, atol=1e-5)


@pytest.mark.parametrize("mesh_kind", ["points4", "grid"])
def test_sharded_sa_level_matches_module(ranks, inputs, mesh_kind):
    """A whole set-abstraction level over four point shards, and over the
    2 x 2 mesh (batch over ``data``, points over ``points``): the JAX
    FPS and kNN indices exactly, the module's centres bit for bit and its
    pooled features within 1e-6."""
    inp = inputs["sa"]
    sa = load_jax_variables(models.backbone.PointNet2SAModule(inp["npoint"], inp["nsample"], inp["c"],
                                                              inp["widths"]), inp["variables"]).eval()
    with torch.inference_mode():
        ref = sa(torch.from_numpy(inp["xyz"]), torch.from_numpy(inp["feats"]))
    jx = jnp.asarray(inp["xyz"])
    j_center = np.asarray(jops.farthest_point_sample(jx, inp["npoint"]))
    j_sample = np.asarray(jops.knn(jx, jops.gather(jx, jnp.asarray(j_center)), inp["nsample"])[0])
    for r in ranks:
        new_xyz, center_idx, sample_idx, pooled = r["sa_" + mesh_kind]
        rows = slice(None) if mesh_kind == "points4" else r["grid_rows"]
        np.testing.assert_array_equal(center_idx.numpy(), j_center[rows])
        np.testing.assert_array_equal(sample_idx.numpy(), j_sample[rows])
        assert torch.equal(new_xyz, ref.new_xyz[rows])
        np.testing.assert_allclose(pooled.numpy(), ref.features[rows].numpy(), atol=1e-6)


@pytest.mark.parametrize("family", ["patch_aug_net", "pptnet_l2_norm", "pointnet_vlad"])
def test_sharded_descriptors(two, inputs, family):
    """The point-sharded descriptors over two shards: every FP feature the
    single-process forward's bits (the finest, each rank's shard of it),
    the descriptor within 1e-6 of it, and for PatchAugNet and
    PointNetVLAD within DESC_TOL of the JAX model's (PPT-Net's
    single-process forward is held to JAX's in ``tests/test_torch_pptnet.py``;
    its oracle would take 3 s of this file's budget)."""
    key, cfg, variables, clouds = {
        "patch_aug_net": ("pan_desc", CFG, inputs["variables"], inputs["records"]),
        "pptnet_l2_norm": ("ppt_desc", PPT_CFG, inputs["ppt_variables"], inputs["ppt_clouds"]),
        "pointnet_vlad": ("pnv_desc", PNV_CFG, inputs["pnv_variables"], inputs["pnv_clouds"]),
    }[family]
    model = _port_model(cfg, variables, family).eval()
    with torch.inference_mode():
        ref = model(torch.from_numpy(clouds[:2]))
    for i, rank in enumerate(two):
        got = rank[key]
        desc = got[0] if family != "pointnet_vlad" else got
        np.testing.assert_allclose(desc.numpy(), serving.global_desc(ref).numpy(), atol=1e-6)
        if family != "pointnet_vlad":
            fine = ref.fp_features[-1]
            shard = fine.shape[1] // 2
            for f, want in zip(got[1][:-1], ref.fp_features[:-1]):
                assert torch.equal(f, want)
            assert torch.equal(got[1][-1], fine[:, i * shard:(i + 1) * shard])
    if family != "pptnet_l2_norm":
        jref = _jax_eval(family)(variables, jnp.asarray(clouds))
        jdesc = np.asarray(getattr(jref, "global_desc", jref))[:2]
        np.testing.assert_allclose(two[0][key][0].numpy() if family != "pointnet_vlad" else two[0][key].numpy(),
                                   jdesc, atol=DESC_TOL)


def test_sharded_train_step(two, inputs):
    """build_sharded_train_step over two point shards: the single-process
    step's loss and parameters (patch losses off); every rank the same."""
    state, metrics = _single_step(PLAIN_CFG, inputs)
    got = two[0]["sharded_step"]
    assert got["metrics"]["total"] > 1e-3
    np.testing.assert_allclose(got["metrics"]["total"], float(metrics["total"]), rtol=STEP_RTOL)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    assert all(rank["sharded_step"]["ranks_agree"] for rank in two)


def _leaf_errors(got, want):
    """Each parameter's gradient error in relative L2, a leaf's norm
    floored at 1e-4 of the largest (the biases before a BatchNorm have
    rounding-noise gradients): a dropped or mis-scaled leaf reads 1 or
    more whatever its size."""
    floor = 1e-4 * max(float(g.norm()) for g in want.values())
    return {k: float((got[k].double() - g.double()).norm()) / max(float(g.norm()), floor) for k, g in want.items()}


def test_sharded_pptnet_train_step(two, inputs):
    """build_sharded_train_step of PPT-Net over two point shards against
    the port's single-process step: the loss within rtol 1e-5, every
    parameter's gradient leaf by leaf within GRAD_RTOL in relative L2
    (measured 2.4e-4 at most, on the GroupSA biases, whose gradients are
    rounding noise below the floor), the parameters within atol 1e-5;
    every rank the same."""
    state = train.create_train_state(_port_model(PPT_STEP_CFG, inputs["ppt_variables"]), PPT_STEP_CFG,
                                     steps_per_epoch=1, device="cpu")
    corr, mask = train.step.empty_patch_inputs(PPT_STEP_CFG, TOTAL)
    state, metrics = train.build_train_step(state.model, PPT_STEP_CFG)(state, inputs["clouds"], corr, mask)
    got = two[0]["ppt_sharded_step"]
    assert got["metrics"]["total"] > 1e-3
    np.testing.assert_allclose(got["metrics"]["total"], float(metrics["total"]), rtol=STEP_RTOL)
    errors = _leaf_errors(got["grads"], {k: p.grad for k, p in state.model.named_parameters()})
    worst = max(errors, key=errors.get)
    assert errors[worst] < GRAD_RTOL, f"{worst}: relative L2 {errors[worst]:.3e}"
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL, err_msg=k)
    assert all(rank["ppt_sharded_step"]["ranks_agree"] for rank in two)


def test_sharded_train_step_refuses_patch_losses_and_applies_the_gate(two):
    """The two faults of the JAX point-sharded step are not carried over:
    a patch loss or a place-recognition weight other than 1.0 is refused,
    and a zero loss zeroes the gradients, so the update (SGD with momentum
    from a zero trace) moves no parameter; the running statistics update."""
    for rank in two:
        assert len(rank["refusals"]) == 2
        assert "use_patch_recon" in rank["refusals"][0] and "weight_place_recognition" in rank["refusals"][1]
        assert rank["gated"]["metrics"]["total"] == 0.0 and rank["gated"]["ranks_agree"]
    gated = two[0]["gated"]
    assert all(float(g.abs().max()) == 0.0 for g in gated["grads"].values())
    for k in gated["grads"]:
        assert torch.equal(gated["params"][k], gated["before"][k]), k
    assert not torch.equal(gated["params"]["sa0.mlp.bn0.running_mean"], gated["before"]["sa0.mlp.bn0.running_mean"])


def test_batchnorm_group_of_one_is_bit_equal(two):
    """Train-mode BatchNorm inside a group of one rank: today's output and
    running statistics bit for bit."""
    assert all(rank["bn_bits_equal"] for rank in two)


def test_more_ranks_than_cards_needs_share_device(monkeypatch):
    """Asking for more ranks than there are cards raises unless the ranks
    may share a card (as the JAX ``make_mesh`` asserts), before any process
    starts; ``make_mesh`` outside a process group raises too."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share_device"):
        parallel.spawn(worker.world, 2, platform="gpu")
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(2)
