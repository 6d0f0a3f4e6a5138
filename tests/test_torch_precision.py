"""The port's mixed-precision path (``COMPUTE_DTYPE: bfloat16``), ``REMAT``
and ``KNN_APPROX_RECALL`` against the JAX package, on the CPU.

Each family at a tiny size (PatchAugNet and PPT-Net at the cuts of their
own test files, PointNetVLAD at its full width, MinkLoc3Dv2 at the JAX
suite's ``SPARSE_PARAM``) on 2 clouds of 256 points: the JAX variable
tree's shapes come from ``jax.eval_shape`` of the f32 model's init, every
leaf is drawn from a numpy generator, and the tree is carried into the
port's bf16 model with ``load_jax_variables``, whose strict walk must take
it whole (the bf16 model's tree is the f32 one). Both sides run the bf16
model on the same numpy clouds.

Indices are exactly equal. Float tolerances, each beside the largest
difference measured on the CPU:
- bf16 descriptors against the JAX bf16 model: BF16_DESC_TOL, 2e-3
  absolute, the bound of the JAX suite's bf16 anchors
  (``tests/test_golden_descriptors.py``) (measured: PatchAugNet 2.0e-5,
  PPT-Net 3.7e-4, PointNetVLAD 6.9e-6, MinkLoc3Dv2 9.3e-5 sparse and
  9.0e-4 dense, on descriptors of norm 1 to 2). Both sides round at the
  same points, but a sum formed in another order can round the other way
  by one bf16 step (2^-8 relative), and the next layers carry it on;
- bf16 FP features: BF16_FEAT_RTOL, 2e-2 of each level's largest
  magnitude (measured 1.3e-2, PPT-Net's finest level, after four GroupSA
  levels);
- the bf16 descriptor against the port's own f32 forward: cosine at
  least 0.999, the JAX suite's bound (``tests/test_models.py``)
  (measured 0.99999904 at least);
- a bf16 ``BatchNorm`` (eval and train mode) against the JAX module: one
  bf16 step, BF16_STEP relative (measured 0.0), its new statistics
  STATS_RTOL, 2e-6 relative (measured 3.6e-7); a bf16 NetVLAD core:
  VLAD_TOL, 1e-6 absolute (measured 3.7e-8);
- ``REMAT`` against the plain step from one copied state: the JAX
  test's bounds (``tests/test_train.py``), the total within 1e-6
  relative and the parameters within 1e-6 absolute (measured 0.0, f32 and
  bf16: the recomputed forward is the same arithmetic), the running
  statistics equal.

The JAX oracles compile with XLA's optimisations and CPU fusion emitters
off (``_jit``), on one torch thread, as ``tests/test_torch_pptnet.py``.
"""
import copy
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from patchaugnet_tpu import ops as jops
from patchaugnet_tpu.models import get_model as jax_get_model
from patchaugnet_tpu.models import minkloc3dv2 as jmk
from patchaugnet_tpu.nn.core import batch_norm as jax_batch_norm
from patchaugnet_tpu.nn.vlad import NetVLADBase as JaxNetVLADBase

from patchaugnet_tpu_torch import configs, ops, serving, train
from patchaugnet_tpu_torch.compat import load_jax_variables, to_jax_variables
from patchaugnet_tpu_torch.models import get_model
from patchaugnet_tpu_torch.nn import BatchNorm, NetVLADBase, seeded_init_
from patchaugnet_tpu_torch.nn.core import compute_dtype

import evaluate_torch
import export_serving_torch
import train_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
BF16 = {"COMPUTE_DTYPE": "bfloat16"}
BF16_DESC_TOL = 2e-3
BF16_FEAT_RTOL = 2e-2
BF16_STEP = 2.0 ** -8      # one step of bf16's 8-bit significand, relative
STATS_RTOL = 2e-6
VLAD_TOL = 1e-6
MIN_COSINE = 0.999

PAN = dict(configs.PATCH_AUG_NET, NUM_POINTS=N, SAMPLING=[32, 8, 4], KNN=[8, 8, 4], MAX_SAMPLES=[8, 32, 128],
           use_patch_recon=False)
PPT = dict(configs.PPTNET_ORIGIN, NUM_POINTS=N, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4],
           FEATURE_SIZE=[32] * 4, OUTPUT_DIM=[32] * 4, CLUSTER_SIZE=[1, 2, 4, 8], MAX_SAMPLES=[8, 16, 32, 128],
           GROUP=8)
PNV = dict(configs.POINTNET_VLAD, NUM_POINTS=N)
# the JAX suite's SPARSE_PARAM cut to two levels and one top-down step
# (tests/test_torch_minkloc.py's STEP_PARAM): the JAX compiles take half as long
MINK = {"feature_size": 64, "output_dim": 64, "planes": [16, 32], "layers": [1, 1], "num_top_down": 1,
        "conv0_kernel_size": 5, "block": "ECABasicBlock", "pooling": "GeM", "coordinates": "cartesian",
        "quantization_step": 0.05, "normalize_embeddings": False}
FAMILIES = {
    "patch_aug_net": dict(PAN, KNN_APPROX_RECALL=0.95),
    "pptnet_l2_norm": PPT,
    "pointnet_vlad": PNV,
    "minkloc3dv2": MINK,
    "minkloc3dv2-dense": dict(MINK, grid_size=16),
}
# the flagship train step at the JAX suite's SMALL_CFG (tests/test_train.py)
STEP_CFG = dict(configs.PATCH_AUG_NET_TRAIN, NUM_POINTS=128, SAMPLING=[32, 8, 4], KNN=[8, 8, 4],
                MAX_SAMPLES=[8, 32, 128], TRAIN_BATCH_SIZE=2, TRAIN_POSITIVES_PER_QUERY=1,
                TRAIN_NEGATIVES_PER_QUERY=2, BASE_LEARNING_RATE=1e-3, MAX_EPOCH=2, A2B_MAX_ROWS=64,
                A2B_MAX_PAIRS=4)
STEP_CLOUDS = 2 * (1 + 1 + 2 + 1)


def _jit(fn):
    """``jax.jit`` with XLA's CPU fusion emitters off (with the module's
    ``jax_disable_most_optimizations``: quick compiles of the same
    programs)."""
    return jax.jit(fn, compiler_options={"xla_cpu_use_fusion_emitters": False})


@pytest.fixture(autouse=True, scope="module")
def _one_thread_quick_compiles():
    threads = torch.get_num_threads()
    optimise = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimise)
    torch.set_num_threads(threads)


def _random_variables(shapes, rng):
    """A JAX variable tree of ``shapes`` drawn from ``rng``: kernels normal
    with std ``1/sqrt(fan_in)`` (every axis but the last), scales and
    running variances uniform in [0.5, 1.5], biases and running means
    normal (std 0.1 and 0.2), GeM's ``p`` uniform in [2, 4]."""
    def fill(key, leaf):
        shape = tuple(leaf.shape)
        if key in ("scale", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if key in ("bias", "mean"):
            return (rng.randn(*shape) * (0.2 if key == "mean" else 0.1)).astype(np.float32)
        if key == "p":
            return (rng.rand(*shape) * 2 + 2).astype(np.float32)
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else fill(k, v) for k, v in tree.items()}

    return walk(shapes)


def _jax_model(family, cfg):
    if family.startswith("minkloc3dv2"):
        return jmk.build_minkloc(cfg)
    return jax_get_model(family, cfg)


def _clouds(family, rng):
    clouds = rng.rand(2, N, 3).astype(np.float32)
    return clouds * 2 - 1 if family.startswith("minkloc3dv2") else clouds


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_case(request):
    """(family, clouds, variables, the JAX bf16 model's eval output) at the
    family's tiny size. The variables' shapes are the port's f32 tree
    (``to_jax_variables``; the JAX apply takes no other tree, and tracing
    the JAX init would take 1.4 s). MinkLoc3Dv2's sparse oracle runs the
    JAX package's im2col convolution (its z-run default compiles 4 s
    longer)."""
    family = request.param
    rng = np.random.RandomState(list(FAMILIES).index(family))
    cfg = FAMILIES[family]
    clouds = _clouds(family, rng)
    variables = _random_variables(to_jax_variables(get_model(family.split("-")[0], cfg)), rng)
    jmodel = _jax_model(family, dict(cfg, **BF16))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCR_SPARSE_CONV", "im2col")
        ref = _jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(clouds))
    return family, clouds, variables, ref


def _port_model(family, cfg, variables):
    model_type = family.split("-")[0]
    return load_jax_variables(get_model(model_type, cfg), variables).eval()


def _desc(out):
    return getattr(out, "global_desc", out)


def test_bf16_forward_matches_jax(family_case):
    """The port's bf16 model on the JAX f32 tree: the JAX bf16 model's
    indices exactly, its descriptor (f32) and FP features (f32) within
    tolerance, and within cosine 0.999 of the port's f32 forward; the
    bf16 model's parameters and statistics are the f32 model's, f32.
    PatchAugNet runs at ``KNN_APPROX_RECALL=0.95`` on both sides, and its
    indices are the exact kNN's (the f32 forward's, which runs without the
    key)."""
    family, clouds, variables, ref = family_case
    cfg = FAMILIES[family]
    model = _port_model(family, dict(cfg, **BF16), variables)
    f32 = _port_model(family, dict(cfg, KNN_APPROX_RECALL=None), variables)
    assert {k: (v.shape, v.dtype) for k, v in model.state_dict().items()} == \
        {k: (v.shape, v.dtype) for k, v in f32.state_dict().items()}
    assert {v.dtype for v in model.state_dict().values()} == {torch.float32}
    x = torch.from_numpy(clouds)
    with torch.inference_mode():
        out, out32 = model(x), f32(x)
    desc = _desc(out)
    assert desc.dtype == torch.float32 and torch.isfinite(desc).all()
    np.testing.assert_allclose(desc.numpy(), np.asarray(_desc(ref)), atol=BF16_DESC_TOL)
    cos = torch.nn.functional.cosine_similarity(desc, _desc(out32), dim=-1)
    assert cos.min().item() >= MIN_COSINE, cos
    for field in ("center_idx_origin", "sample_idx_origin"):
        for want, got, got32 in zip(getattr(ref, field, ()), getattr(out, field, ()), getattr(out32, field, ())):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert torch.equal(got, got32)
    for want, got in zip(getattr(ref, "fp_features", ()), getattr(out, "fp_features", ())):
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=BF16_FEAT_RTOL * np.abs(want).max())
    if family.startswith("minkloc3dv2") and model.backend == "sparse":
        # the geometry is the f32 path's: tables and kernel maps equal
        for a, b in zip(model.pyramid(x), f32.pyramid(x)):
            for s, t in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                assert torch.equal(s, t) if isinstance(s, torch.Tensor) else s == t


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_bf16_batch_norm_matches_jax(train_mode):
    """``batch_norm(dtype=bfloat16)`` of the JAX package: f32 statistics and
    normalisation, the output rounded to bf16; the running update f32."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 40, 16) * 2 + 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = {"params": {"scale": (rng.rand(16) + 0.5).astype(np.float32),
                            "bias": (rng.randn(16) * 0.1).astype(np.float32)},
                 "batch_stats": {"mean": (rng.randn(16) * 0.2).astype(np.float32),
                                 "var": (rng.rand(16) + 0.5).astype(np.float32)}}
    jbn = jax_batch_norm(dtype=jnp.bfloat16)
    want, mutated = _jit(lambda v, a: jbn.apply(v, a, use_running_average=not train_mode,
                                               mutable=["batch_stats"]))(variables, xb)
    assert want.dtype == jnp.bfloat16
    bn = load_jax_variables(BatchNorm(16), variables).train(train_mode)
    got = bn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32), rtol=BF16_STEP)
    if train_mode:
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]),
                                   rtol=STATS_RTOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]),
                                   rtol=STATS_RTOL)


def test_bf16_netvlad_core_matches_jax():
    """``NetVLADBase(dtype=bfloat16)``: the two N-sized products on bf16
    operands accumulated in f32, the softmax and norms f32; an f32 output."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 64, 32).astype(np.float32)
    jmod = JaxNetVLADBase(32, 8, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _random_variables(shapes, rng)
    want = _jit(lambda v, a: jmod.apply(v, a))(variables, jnp.asarray(x, jnp.bfloat16))
    core = load_jax_variables(NetVLADBase(32, 8, dtype=torch.bfloat16), variables).eval()
    with torch.inference_mode():
        got = core(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VLAD_TOL)


def test_compute_dtype_names():
    assert compute_dtype({}) is None and compute_dtype({"COMPUTE_DTYPE": None}) is None
    assert compute_dtype(BF16) is torch.bfloat16
    assert compute_dtype({"compute_dtype": "bfloat16"}) is torch.bfloat16
    assert compute_dtype({"COMPUTE_DTYPE": "float16"}) is torch.float16
    with pytest.raises(ValueError, match="COMPUTE_DTYPE"):
        compute_dtype({"COMPUTE_DTYPE": "int8"})


def test_knn_approx_recall_runs_the_exact_knn():
    """``approx_recall`` (``KNN_APPROX_RECALL``; ``lax.approx_max_k`` in the
    JAX package, exact off the TPU) gives the JAX kNN's indices at that
    target, which are the exact kNN's; a target outside (0, 1] raises. (The
    PatchAugNet case of ``test_bf16_forward_matches_jax`` runs the model at
    ``KNN_APPROX_RECALL=0.95`` on both sides.)"""
    rng = np.random.RandomState(7)
    pts, qry = rng.rand(2, 300, 3).astype(np.float32), rng.rand(2, 40, 3).astype(np.float32)
    want = _jit(lambda p, q: jops.knn(p, q, 16, approx_recall=0.95))(jnp.asarray(pts), jnp.asarray(qry))
    idx, d2 = ops.knn(torch.from_numpy(pts), torch.from_numpy(qry), 16, approx_recall=0.95)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    assert torch.equal(idx, ops.knn(torch.from_numpy(pts), torch.from_numpy(qry), 16)[0])
    with pytest.raises(ValueError, match="approx_recall"):
        ops.knn(torch.from_numpy(pts), None, 4, approx_recall=1.5)


def _step_batch(seed=0):
    rng = np.random.RandomState(seed)
    clouds = rng.rand(STEP_CLOUDS, STEP_CFG["NUM_POINTS"], 3).astype(np.float32)
    corr, mask = train.empty_patch_inputs(STEP_CFG, STEP_CLOUDS)
    mask[[0, 1, 5, 6]] = True
    return clouds, corr, mask


def _step_state(cfg, seed=3):
    model = seeded_init_(get_model(cfg["model_type"], cfg), torch.Generator().manual_seed(seed))
    return train.create_train_state(model, cfg, device="cpu")


def test_bf16_train_step_reduces_the_loss():
    """The flagship bf16 train step (``tests/test_train.py``'s bf16 test):
    eight steps on one batch reduce the total, every parameter, Adam
    moment and BatchNorm statistic stays f32."""
    cfg = dict(STEP_CFG, **BF16)
    state = _step_state(cfg)
    step = train.build_train_step(state.model, cfg)
    clouds, corr, mask = _step_batch()
    totals = []
    for _ in range(8):
        state, metrics = step(state, clouds, corr, mask)
        totals.append(metrics["total"].item())
        assert metrics["patch_recon_a2a"].item() > 0
    assert np.isfinite(totals).all() and totals[-1] < totals[0], totals
    assert {t.dtype for t in state.model.state_dict().values()} == {torch.float32}
    moments = [v for s in state.optimizer.state.values() for v in s.values() if v.dim() > 0]
    assert moments and {m.dtype for m in moments} == {torch.float32}


@pytest.mark.parametrize("family", ["pptnet", "pointnet_vlad", "minkloc3dv2"])
def test_bf16_train_steps_of_the_other_families(family):
    """PPT-Net's and PointNetVLAD's bf16 steps (``train.build_train_step``,
    5 clouds) and MinkLoc3Dv2's bf16 SmoothAP step (8 clouds): finite
    metrics, every parameter moved and f32, the statistics f32."""
    rng = np.random.RandomState(5)
    if family == "minkloc3dv2":
        model = seeded_init_(get_model(family, dict(MINK, **BF16)), torch.Generator().manual_seed(1))
        step, tx = train.build_smoothap_train_step(model, train.multistep_schedule(1e-3, [10], 1),
                                                   weight_decay=1e-4)
        state = train.create_train_state(model, {}, device="cpu", tx=tx)
        clouds = rng.rand(8, N, 3).astype(np.float32) * 2 - 1
        pos = np.zeros((8, 8), bool)
        for i in range(0, 8, 2):
            pos[i, i + 1] = pos[i + 1, i] = True
        neg = ~pos & ~np.eye(8, dtype=bool)
        args = (clouds, pos, neg)
    else:
        cfg = dict(PPT if family == "pptnet" else PNV, **BF16, model_type=family, TRAIN_BATCH_SIZE=1,
                   TRAIN_POSITIVES_PER_QUERY=1, TRAIN_NEGATIVES_PER_QUERY=2, BASE_LEARNING_RATE=1e-3)
        state = _step_state(cfg)
        step = train.build_train_step(state.model, cfg)
        corr, mask = train.empty_patch_inputs(cfg, 5)
        clouds = rng.rand(5, 128, 3).astype(np.float32)
        clouds[2:4] = clouds[0]             # negatives on the query: the hinges are open
        args = (clouds, corr, mask)
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    state, metrics = step(state, *args)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    moved = [k for k, v in state.model.named_parameters() if not torch.equal(v, before[k])]
    assert len(moved) > len(before) // 2
    assert {t.dtype for t in state.model.state_dict().values()} == {torch.float32}


class _PanOps(TorchDispatchMode):
    """Counts the calls of the port's operators (``pan::fps``, ``pan::knn``)
    in its scope, the backward's recomputation included."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.name())
        if name.startswith("pan::"):
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_step_matches_plain():
    """``REMAT`` (the forward recomputed in the backward) against the plain
    step from one copied state, at the JAX test's bounds: the total within
    1e-6 relative, every parameter within 1e-6 absolute, and the running
    statistics those of the plain step, updated once (they moved). The
    recomputation runs the kernels' operators again: ``pan::fps`` 6 and
    ``pan::knn`` 12 times in the step, 3 and 6 without ``REMAT``. The bf16
    step with ``REMAT`` runs in ``test_cli_bf16_train_evaluate_export``."""
    cfg = STEP_CFG
    state = _step_state(cfg)
    stats0 = {k: v.clone() for k, v in state.model.named_buffers()}
    batch = _step_batch(1)
    results = []
    for c in (cfg, dict(cfg, REMAT=True)):
        s = copy.deepcopy(state)
        with _PanOps() as calls:
            s, metrics = train.build_train_step(s.model, c)(s, *batch)
        results.append((metrics["total"].item(), dict(s.model.named_parameters()), dict(s.model.named_buffers())))
        assert calls.counts == ({"pan::fps": 6, "pan::knn": 12} if c.get("REMAT") else
                                {"pan::fps": 3, "pan::knn": 6}), calls.counts
    (t0, p0, b0), (t1, p1, b1) = results
    np.testing.assert_allclose(t1, t0, rtol=1e-6)
    for name, value in p0.items():
        np.testing.assert_allclose(p1[name].detach().numpy(), value.detach().numpy(), atol=1e-6, err_msg=name)
    for name, value in b0.items():
        assert torch.equal(b1[name], value), name
    assert any(not torch.equal(b0[k], v) for k, v in stats0.items() if "running" in k)


def test_cli_bf16_train_evaluate_export(tmp_path, monkeypatch):
    """``train_torch.py --precision bfloat16 --remat`` for one batch of the
    tiny configuration, ``evaluate_torch.py --precision bfloat16`` on its
    checkpoint (its descriptors the live bf16 model's, within the bf16
    tolerance of another batch size), and ``export_serving_torch.py
    --precision bfloat16`` of it: the artifact (``precision`` in its
    sidecar) serves the live bf16 forward's descriptors, bit for bit."""
    monkeypatch.chdir(REPO)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    config = os.path.join(REPO, "configs", "tiny_smoke.yaml")
    run = train_torch.main(["--config", config, "--dataset", "synthetic", "--platform", "cpu", "--epochs", "1",
                            "--max-batches", "1", "--exp_dir", str(tmp_path / "exp"), "--precision", "bfloat16",
                            "--remat"])
    assert run["cfg"]["COMPUTE_DTYPE"] == "bfloat16" and run["cfg"]["REMAT"]
    assert run["state"].model.compute_dtype is torch.bfloat16
    assert {t.dtype for t in run["state"].model.state_dict().values()} == {torch.float32}
    assert all(np.isfinite(v) for v in run["summaries"][0].values() if isinstance(v, float))
    ckpt = os.path.join(run["cfg"]["save_path"], "train_epoch_0_end")
    argv = ["--config", config, "--weight", ckpt, "--platform", "cpu", "--precision", "bfloat16"]
    out = evaluate_torch.main(argv + ["--dataset", "synthetic", "--exp_dir", str(tmp_path / "eval"),
                                      "--no_save_top_k"])
    assert out["num_pairs"] == 2 and 0 <= out["recall_at_1"] <= 100
    cfg = dict(configs.TINY_SMOKE, **BF16)
    live = evaluate_torch.load_state("patch_aug_net", cfg, ckpt, torch.device("cpu")).model
    assert live.compute_dtype is torch.bfloat16
    scene = out["test_ds"].scene
    clouds = scene.get_clouds([0, 1])[0]
    forward = serving.build_forward_fn(live, "cpu")
    np.testing.assert_allclose(scene.global_descs[:2], forward(clouds).numpy(), atol=BF16_DESC_TOL)
    (path,) = export_serving_torch.main(argv + ["--out", str(tmp_path / "serving"), "--batch_sizes", "2"])
    fwd, meta = serving.load_artifact(path)
    got = fwd(clouds)
    assert got.dtype == torch.float32 and meta["precision"] == "bfloat16"
    assert torch.equal(got, forward(clouds))
