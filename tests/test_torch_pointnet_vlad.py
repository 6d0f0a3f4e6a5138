"""The port's PointNetVLAD and PointNet blocks against the JAX package, on
the CPU.

The model at its own widths (STNs, 1024-d point features, a NetVLAD of 64
clusters, 256-d output) on clouds of 64 points: the JAX variable tree's
shapes come from ``jax.eval_shape`` of the JAX model's init, every leaf
is drawn from a numpy generator (the STNs' ``fc3`` too, which the JAX
initialiser zeroes, so that the transforms are not the identity, and the
BatchNorm statistics away from their defaults), and the tree is carried
into the port with ``load_jax_variables``, whose strict walk must take it
whole. Both sides take the same numpy clouds.

Float tolerances, each beside the largest difference measured on the CPU:
- the eval descriptor: 1e-4 absolute (measured 6.0e-8);
- ``STN3D``, ``GatingContext`` without BatchNorm, ``PointNetAutoencoder``:
  2e-5 absolute (measured 5.3e-6, 6.0e-8 and 2.9e-7), new BatchNorm
  statistics 2e-5 relative plus 1e-6 absolute (the largest difference 14%
  of that bound);
- the first train step (``make_loss_fn``, 1 x (1 + 1 + 2 + 1) = 5 clouds),
  against the JAX loss in float64 (see the test): metrics 5e-5 relative
  (measured 3.2e-6), new batch statistics 2e-5 relative plus 1e-6
  absolute (4% of that bound), every gradient leaf 1e-4 in relative L2
  (measured 8.2e-6; the biases ahead of a train-mode BatchNorm, whose true
  gradient is zero, 5.5e-8 of the whole gradient's norm): no geometry op
  lies on this path, so nothing but rounding separates the two.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import train as jtrain
from patchaugnet_tpu.models import get_model as jax_get_model
from patchaugnet_tpu.nn.pointnet import STN3D as JaxSTN3D
from patchaugnet_tpu.nn.pointnet import PointNetAutoencoder as JaxPointNetAutoencoder
from patchaugnet_tpu.nn.vlad import GatingContext as JaxGatingContext

from patchaugnet_tpu_torch import configs, serving, train
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.models import PointNetVLAD, get_model
from patchaugnet_tpu_torch.nn import STN3D, GatingContext, PointNetAutoencoder, training_init_

CFG = dict(configs.POINTNET_VLAD, NUM_POINTS=64, TRAIN_BATCH_SIZE=1, TRAIN_POSITIVES_PER_QUERY=1,
           TRAIN_NEGATIVES_PER_QUERY=2)
TOTAL = 1 + 1 + 2 + 1
DESC_TOL = 1e-4
BLOCK_TOL = 2e-5
STATS_RTOL = 2e-5
LOSS_RTOL = 5e-5
GRAD_RTOL = 1e-4


def _jit(fn):
    """``jax.jit`` for the oracles: XLA's CPU fusion emitters off, with the
    module's ``jax_disable_most_optimizations``, so that they compile in a
    fraction of the time on one core. The programs compute the same
    functions."""
    return jax.jit(fn, compiler_options={"xla_cpu_use_fusion_emitters": False})


@pytest.fixture(autouse=True, scope="module")
def _one_thread_quick_compiles():
    """One torch thread, and XLA's optimisation passes off while this
    module compiles its JAX oracles (see ``_jit``)."""
    threads = torch.get_num_threads()
    optimise = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimise)
    torch.set_num_threads(threads)


def _random_variables(module, x, rng):
    """A JAX variable tree for ``module`` on input ``x``, its shapes from
    ``jax.eval_shape`` of the init, drawn from ``rng``: kernels and raw
    weights normal with std ``1/sqrt(fan_in)`` (the fan over every axis but
    the last), scales and running variances uniform in [0.5, 1.5], biases
    and running means normal with std 0.1 and 0.2."""
    def fill(key, leaf):
        shape = tuple(leaf.shape)
        if key in ("scale", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if key in ("bias", "mean"):
            return (rng.randn(*shape) * (0.2 if key == "mean" else 0.1)).astype(np.float32)
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else fill(k, v) for k, v in tree.items()}

    return walk(jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x)))


def _apply(module, variables, x, train_mode=False):
    """JAX ``(output, new batch statistics)`` of ``module`` on ``x``."""
    out, mutated = _jit(lambda v, x: module.apply(v, x, train=train_mode, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    return out, mutated.get("batch_stats", {})


def _assert_stats(module, jax_stats):
    """Every running statistic of ``module`` against the JAX tree's."""
    names = list(module.named_buffers())
    assert len(names) == len(jax.tree_util.tree_leaves(jax_stats))
    for name, t in names:
        *path, leaf = name.split(".")
        want = jax_stats
        for key in path:
            want = want[key]
        want = np.asarray(want["mean" if leaf == "running_mean" else "var"])
        np.testing.assert_allclose(t.detach().numpy(), want, rtol=STATS_RTOL, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def carried():
    """(clouds, variables, the JAX model's eval descriptor)."""
    rng = np.random.RandomState(0)
    clouds = rng.rand(3, CFG["NUM_POINTS"], 3).astype(np.float32)
    model = jax_get_model("pointnet_vlad", CFG)
    variables = _random_variables(model, clouds, rng)
    desc, _ = _apply(model, variables, clouds)
    return clouds, variables, np.asarray(desc)


def test_forward_matches_jax(carried):
    """The eval descriptor, a bare ``(B, 256)`` tensor, within DESC_TOL."""
    clouds, variables, want = carried
    model = load_jax_variables(get_model("pointnet_vlad", CFG), variables).eval()
    assert isinstance(model, PointNetVLAD)
    with torch.inference_mode():
        got = model(torch.from_numpy(clouds))
    assert isinstance(got, torch.Tensor) and got.shape == (3, 256)
    np.testing.assert_allclose(want, got.numpy(), atol=DESC_TOL)


def test_serving_takes_a_model_without_local_descriptors(carried):
    """The serving forward returns the bare descriptor of PointNetVLAD (the
    JAX ``_global_desc``); its local forward is ``None``, as the JAX
    ``build_local_forward_fn`` returns for models without locals."""
    clouds, variables, want = carried
    model = load_jax_variables(get_model("pointnet_vlad", CFG), variables)
    assert serving.build_local_forward_fn(model, device="cpu") is None
    assert train.build_local_forward_fn(model, device="cpu") is None
    got = serving.build_forward_fn(model, device="cpu")(clouds)
    assert got.shape == (3, 256) and model.training
    np.testing.assert_allclose(want, got.numpy(), atol=DESC_TOL)


@pytest.mark.parametrize("k, use_bn, mode", [(3, True, "eval"), (3, True, "train"), (3, False, "eval"),
                                             (64, False, "train")])
def test_stn3d_matches_jax(k, use_bn, mode):
    """STN3D in both ``use_bn`` modes, with a random ``fc3``: the
    transform, and in train mode the new statistics. The 8 inputs differ
    in scale (0.5 to 2), so that the pooled features' batch variance in
    fc1 and fc2 is not a cancellation of near-equal rows."""
    rng = np.random.RandomState(k)
    x = (rng.randn(8, 32, k) * np.linspace(0.5, 2, 8)[:, None, None]).astype(np.float32)
    jm = JaxSTN3D(k=k, use_bn=use_bn)
    variables = _random_variables(jm, x, rng)
    want, want_stats = _apply(jm, variables, x, mode == "train")
    module = load_jax_variables(STN3D(k=k, use_bn=use_bn), variables).train(mode == "train")
    assert hasattr(module, "conv1_bn") == use_bn
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert got.shape == (8, k, k)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=BLOCK_TOL)
    _assert_stats(module, want_stats)


def test_training_init_starts_at_the_identity():
    """After ``training_init_`` both STNs of PointNetVLAD return the
    identity (their ``fc3`` at zero, as the JAX initialiser makes it), the
    other weights are random, and ``seeded_init_`` zeroes ``fc3`` too."""
    model = training_init_(get_model("pointnet_vlad", CFG), torch.Generator().manual_seed(0)).train()
    x = torch.rand(2, CFG["NUM_POINTS"], 3)
    with torch.no_grad():
        for stn, inp in ((model.point_net.stn, x), (model.point_net.feature_trans, torch.rand(2, 64, 64))):
            assert not stn.fc3.weight.any() and not stn.fc3.bias.any() and stn.fc2.weight.any()
            assert torch.equal(stn(inp), torch.eye(stn.k).expand(2, stn.k, stn.k))
    assert model.net_vlad.hidden1_weights.std().item() == pytest.approx(1 / 1024 ** 0.5, rel=0.05)


def test_gating_without_batch_norm_matches_jax():
    """``GatingContext`` with ``add_batch_norm=False``: ``gating_biases`` in
    place of its BatchNorm."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 16).astype(np.float32)
    jm = JaxGatingContext(16, add_batch_norm=False)
    variables = _random_variables(jm, x, rng)
    want, _ = _apply(jm, variables, x)
    module = load_jax_variables(GatingContext(16, add_batch_norm=False), variables).eval()
    assert set(dict(module.named_parameters())) == {"gating_weights", "gating_biases"}
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=BLOCK_TOL)


def test_autoencoder_matches_jax():
    """``PointNetAutoencoder`` (the encoder, the normalised code, the
    decoder) in eval mode: the patches and the code."""
    rng = np.random.RandomState(6)
    x = rng.rand(2, 32, 3).astype(np.float32)
    jm = JaxPointNetAutoencoder(embedding_size=16, output_num_points=8)
    variables = _random_variables(jm, x, rng)
    (want_y, want_z), _ = _apply(jm, variables, x)
    module = load_jax_variables(PointNetAutoencoder(16, 8), variables).eval()
    with torch.no_grad():
        y, z = module(torch.from_numpy(x))
    assert y.shape == (2, 8, 3) and z.shape == (2, 16)
    np.testing.assert_allclose(np.asarray(want_z), z.numpy(), atol=BLOCK_TOL)
    np.testing.assert_allclose(np.asarray(want_y), y.numpy(), atol=BLOCK_TOL)


def test_loss_fn_matches_jax(carried):
    """One train-mode loss on a tuple batch of 5 clouds against the JAX
    ``make_loss_fn`` run in float64 on the same (float32) weights and
    clouds: the metrics, the new batch statistics, and every gradient leaf
    within GRAD_RTOL in relative L2. The reference is float64 because the
    JAX loss's own float32 backward lies up to 1.2e-2 from it below conv3
    (the feature transform, conv1-3 and the input STN; the port's float32
    within 5e-6 there). The conv biases ahead of a train-mode BatchNorm
    have a true gradient of zero: they are held within GRAD_RTOL of the
    whole gradient's norm."""
    _, variables, _ = carried
    clouds = np.random.RandomState(2).rand(TOTAL, CFG["NUM_POINTS"], 3).astype(np.float32)
    jcorr, jmask = jtrain.step.empty_patch_inputs(CFG, TOTAL)
    jax_loss = jtrain.step.make_loss_fn(jax_get_model("pointnet_vlad", CFG), CFG)
    wide = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        (_, (want_metrics, want_stats)), want_grads = _jit(jax.value_and_grad(jax_loss, has_aux=True))(
            wide["params"], wide["batch_stats"], jnp.asarray(clouds, jnp.float64), jcorr, jmask)
        want_metrics = {k: float(v) for k, v in want_metrics.items()}
        want_stats, want_grads = jax.tree.map(np.asarray, (want_stats, want_grads))

    net = load_jax_variables(get_model("pointnet_vlad", CFG), variables).train()
    corr, mask = train.empty_patch_inputs(CFG, TOTAL)
    total, metrics = train.make_loss_fn(net, CFG)(torch.from_numpy(clouds), corr, mask)
    assert set(metrics) == set(want_metrics) == {"place_recognition", "total"}
    for key, value in want_metrics.items():
        np.testing.assert_allclose(metrics[key].item(), value, rtol=LOSS_RTOL, err_msg=key)
    assert total.item() > 0
    _assert_stats(net, want_stats)

    total.backward()
    carrier = load_jax_variables(get_model("pointnet_vlad", CFG).double(), {
        "params": want_grads, "batch_stats": wide["batch_stats"]})
    pairs = [(name, p.grad.numpy(), q.detach().numpy())
             for (name, p), q in zip(net.named_parameters(), carrier.parameters())]
    whole = np.sqrt(sum(np.sum(want ** 2) for _, _, want in pairs))
    for name, got, want in pairs:
        ahead_of_bn = name.startswith("point_net.conv") and name.endswith(".bias")
        scale = whole if ahead_of_bn else np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= GRAD_RTOL * scale, (name, np.linalg.norm(got - want) / scale)
