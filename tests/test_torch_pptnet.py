"""The port's PPT-Net against the JAX package, on the CPU.

A tiny PPT-Net (128 points, SAMPLING [32, 16, 8, 4], KNN [8, 8, 4, 4],
FEATURE_SIZE and OUTPUT_DIM [32] * 4, CLUSTER_SIZE [1, 2, 4, 8], GROUP 8;
the SA widths are the model's own, 64 to 512): the JAX variable tree's
shapes come from ``jax.eval_shape`` of the JAX model's init, every leaf
is drawn from a numpy generator (BatchNorm statistics included, away
from their defaults), and the tree is carried into the port with
``load_jax_variables``, whose strict walk must take it whole. Both sides
take the same numpy clouds.

Indices are exactly equal. Float tolerances, each beside the largest
difference measured on the CPU:
- the eval forward: descriptor and FP features 1e-4 absolute (measured
  1.7e-6);
- ``GroupSA`` and ``SA`` alone: output 1e-5 absolute (measured 2.4e-6),
  new BatchNorm statistics 2e-5 relative (measured 1.2e-7 absolute);
- ``GroupSA``'s gradients in train mode (every parameter, the tied
  ``kernel`` included, and the input): 1e-4 in relative L2 (measured
  9.5e-7; the two biases whose true gradient is zero, see the test,
  against the whole gradient's norm);
- the first train step (``make_loss_fn``, 1 x (1 + 1 + 2 + 1) = 5 clouds),
  against the JAX loss run in float64 on the same float32 weights and
  clouds, whose provenance indices equal the port's: metrics 5e-5 relative
  (measured 1.8e-5), new batch statistics 2e-5 relative plus 1e-6 absolute
  (the largest difference 24% of that bound), and the head's gradients
  1e-4 in relative L2 (measured 2.6e-5).

The JAX oracles compile with XLA's optimisations and CPU fusion emitters
off (``_jit``), which keeps this file to about 10 s on one core.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import train as jtrain
from patchaugnet_tpu.models import get_model as jax_get_model
from patchaugnet_tpu.nn.attention import SA as JaxSA
from patchaugnet_tpu.nn.attention import GroupSA as JaxGroupSA
from patchaugnet_tpu.nn.core import l2_normalize as jax_l2_normalize

from patchaugnet_tpu_torch import configs, serving, train
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.models import PPTNet, get_model
from patchaugnet_tpu_torch.nn import SA, GroupSA

CFG = dict(configs.PPTNET_ORIGIN, NUM_POINTS=128, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4],
           FEATURE_SIZE=[32] * 4, OUTPUT_DIM=[32] * 4, CLUSTER_SIZE=[1, 2, 4, 8], MAX_SAMPLES=[8, 16, 32, 128],
           GROUP=8, TRAIN_BATCH_SIZE=1, TRAIN_POSITIVES_PER_QUERY=1, TRAIN_NEGATIVES_PER_QUERY=2)
TOTAL = 1 + 1 + 2 + 1
DESC_TOL = 1e-4
SA_TOL = 1e-5
STATS_RTOL = 2e-5
LOSS_RTOL = 5e-5
GRAD_RTOL = 1e-4


def _jit(fn):
    """``jax.jit`` for the oracles: XLA's CPU fusion emitters off (with the
    module's ``jax_disable_most_optimizations``, compiling the tiny PPT-Net
    takes 1.0 s on one core instead of 6.8). The programs compute the same
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


def _random_variables(shapes, rng):
    """A JAX variable tree of the shapes in ``shapes`` (``jax.eval_shape``
    of an init), drawn from ``rng``: kernels and raw weights normal with
    std ``1/sqrt(fan_in)`` (the fan over every axis but the last), scales
    and running variances uniform in [0.5, 1.5], biases and running means
    normal with std 0.1 and 0.2."""
    def fill(key, leaf):
        shape = tuple(leaf.shape)
        if key in ("scale", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if key in ("bias", "mean"):
            return (rng.randn(*shape) * (0.2 if key == "mean" else 0.1)).astype(np.float32)
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v) for k, v in tree.items()}

    return walk(shapes)


def _as_dict(tree):
    return {k: _as_dict(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


@pytest.fixture(scope="module")
def carried():
    """(clouds, variables, JAX eval outputs of ``pptnet`` and ``pptnet_l2_norm``).
    The two JAX models differ only in the descriptor's final
    ``l2_normalize``, so the second output is the first with the JAX
    package's ``l2_normalize`` applied to its descriptor (one compile)."""
    rng = np.random.RandomState(0)
    clouds = rng.rand(3, CFG["NUM_POINTS"], 3).astype(np.float32)
    model = jax_get_model("pptnet", CFG)
    assert not model.use_normalize and jax_get_model("pptnet_l2_norm", CFG).use_normalize
    shapes = _as_dict(jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(clouds)))
    variables = _random_variables(shapes, rng)
    ref = _jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(clouds))
    refs = {"pptnet": ref, "pptnet_l2_norm": ref._replace(global_desc=jax_l2_normalize(ref.global_desc, axis=-1))}
    return clouds, variables, refs


@pytest.mark.parametrize("model_type", ["pptnet", "pptnet_l2_norm"])
def test_forward_matches_jax(carried, model_type):
    """Provenance indices exactly equal; descriptors and FP features within
    DESC_TOL; ``pptnet_l2_norm`` unit-norm, ``pptnet`` not normalised."""
    clouds, variables, refs = carried
    ref = refs[model_type]
    model = load_jax_variables(get_model(model_type, CFG), variables).eval()
    assert isinstance(model, PPTNet) and model.use_normalize == (model_type == "pptnet_l2_norm")
    with torch.inference_mode():
        out = model(torch.from_numpy(clouds))
    assert out.global_desc.shape == (3, 32)
    assert len(out.center_idx_origin) == 4
    for want, got in zip(ref.center_idx_origin, out.center_idx_origin):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_allclose(np.asarray(ref.global_desc), out.global_desc.numpy(), atol=DESC_TOL)
    assert [f.shape[1] for f in out.fp_features] == [8, 16, 32, 128]
    for want, got in zip(ref.fp_features, out.fp_features):
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=DESC_TOL)
    norms = np.linalg.norm(out.global_desc.numpy(), axis=-1)
    if model_type == "pptnet_l2_norm":
        np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    else:
        assert np.abs(norms - 1).max() > 1e-2
    g, local, centers = serving.build_local_forward_fn(model, device="cpu")(clouds)
    np.testing.assert_array_equal(g.numpy(), out.global_desc.numpy())
    np.testing.assert_array_equal(local.numpy(), out.fp_features[-2].numpy())
    np.testing.assert_array_equal(centers.numpy(), out.center_idx_origin[0].numpy())


def _stats(module):
    return {name: t.numpy() for name, t in module.named_buffers()}


@pytest.mark.parametrize("block, mode", [("GroupSA", "eval"), ("GroupSA", "train"), ("SA", "eval"),
                                         ("SA", "train")])
def test_self_attention_matches_jax(block, mode):
    """The attention blocks alone on (2, 16, 64) features: the output, and
    in train mode the new ``after_norm`` statistics."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 64).astype(np.float32)
    jm = JaxGroupSA(64, 8) if block == "GroupSA" else JaxSA(64)
    shapes = _as_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rng)
    train_mode = mode == "train"
    out, mutated = _jit(lambda v, x: jm.apply(v, x, train=train_mode, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    module = load_jax_variables(GroupSA(64, 8) if block == "GroupSA" else SA(64), variables)
    module.train(train_mode)
    if block == "GroupSA":
        assert tuple(module.qk_conv.kernel.shape) == (8, 8, 8)
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(out), got.numpy(), atol=SA_TOL)
    stats = _stats(module)
    want = mutated["batch_stats"]["after_norm"]
    np.testing.assert_allclose(stats["after_norm.running_mean"], np.asarray(want["mean"]), rtol=STATS_RTOL, atol=1e-7)
    np.testing.assert_allclose(stats["after_norm.running_var"], np.asarray(want["var"]), rtol=STATS_RTOL)


def _stats_of(net):
    return {name: t.detach().double().numpy() for name, t in net.named_buffers()}


def _jax_stats(tree, names):
    """The JAX tree's statistics under the port's buffer names."""
    out = {}
    for name in names:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node[key]
        out[name] = np.asarray(node["mean" if leaf == "running_mean" else "var"], np.float64)
    return out


def test_group_sa_gradients_match_jax():
    """``GroupSA`` in train mode on (2, 16, 64) features: the gradients of
    a fixed random projection of its output with respect to every
    parameter (the tied ``qk_conv.kernel``, whose gradient sums the query's
    and the key's share) and to the input, each within GRAD_RTOL in
    relative L2."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 64).astype(np.float32)
    w = rng.randn(2, 16, 64).astype(np.float32)
    jm = JaxGroupSA(64, 8)
    variables = _random_variables(_as_dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))), rng)

    def objective(params, x):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * w)

    want_params, want_x = _jit(jax.grad(objective, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    module = load_jax_variables(GroupSA(64, 8), variables).train()
    xt = torch.from_numpy(x).requires_grad_()
    (module(xt) * torch.from_numpy(w)).sum().backward()
    carrier = load_jax_variables(GroupSA(64, 8), {"params": jax.tree.map(np.asarray, want_params),
                                                  "batch_stats": variables["batch_stats"]})
    pairs = [(name, p.grad.numpy(), q.detach().numpy())
             for (name, p), q in zip(module.named_parameters(), carrier.parameters())]
    pairs.append(("x", xt.grad.numpy(), np.asarray(want_x)))
    assert [name for name, _, _ in pairs] == ["qk_conv.kernel", "v_conv.weight", "v_conv.bias", "trans_conv.weight",
                                              "trans_conv.bias", "after_norm.weight", "after_norm.bias", "x"]
    whole = np.sqrt(sum(np.sum(want ** 2) for _, _, want in pairs))
    for name, got, want in pairs:
        # v = v_conv(x) reaches x_r through columns of attn that sum to 1, so v_conv's bias, like
        # trans_conv's, only shifts every point alike ahead of a train-mode BatchNorm: their true
        # gradients are zero, and they are held within GRAD_RTOL of the whole gradient's norm
        scale = whole if name in ("v_conv.bias", "trans_conv.bias") else np.linalg.norm(want)
        assert np.linalg.norm(got - want) <= GRAD_RTOL * scale, (name, np.linalg.norm(got - want) / scale)


def test_loss_fn_matches_jax(carried):
    """One train-mode loss on a tuple batch of 5 clouds against the JAX
    ``make_loss_fn`` run in float64 on the same (float32) weights and
    clouds, after the JAX model's float64 provenance indices on these
    clouds are found equal to the port's: the metrics within LOSS_RTOL,
    the new batch statistics within STATS_RTOL plus 1e-6, and the
    gradients of the head (the aggregation) leaf by leaf within GRAD_RTOL.

    The reference is float64 because train-mode BatchNorms over 5 clouds
    amplify rounding through four levels: JAX's own float32 loss lies
    3.4e-4 from the float64 value, and its eager and jitted float32 runs
    3.0e-4 apart. The JAX gradient is taken with respect to the head's
    leaves only, so XLA compiles no backward through the backbone (that
    program takes 14 s to compile on one core); the backbone's attention
    blocks are held by ``test_group_sa_gradients_match_jax``."""
    _, variables, _ = carried
    rng = np.random.RandomState(2)
    clouds = rng.rand(TOTAL, CFG["NUM_POINTS"], 3).astype(np.float32)
    jcorr, jmask = jtrain.step.empty_patch_inputs(CFG, TOTAL)
    model = jax_get_model("pptnet", CFG)
    jax_loss = jtrain.step.make_loss_fn(model, CFG)
    wide = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    heads = {"aggregation": wide["params"]["aggregation"]}
    rest = {k: v for k, v in wide["params"].items() if k not in heads}
    with jax.enable_x64(True):
        wide_clouds = jnp.asarray(clouds, jnp.float64)
        want_centers = _jit(lambda v, x: model.apply(v, x, train=False).center_idx_origin)(wide, wide_clouds)
        (_, (want_metrics, want_stats)), want_grads = _jit(jax.value_and_grad(
            lambda h, x: jax_loss({**rest, **h}, wide["batch_stats"], x, jcorr, jmask), has_aux=True))(
            heads, wide_clouds)
        want_metrics = {k: float(v) for k, v in want_metrics.items()}
        want_centers, want_stats, want_grads = jax.tree.map(np.asarray, (want_centers, want_stats, want_grads))

    net = load_jax_variables(get_model("pptnet", CFG), variables).train()
    outs = []
    net.register_forward_hook(lambda module, args, out: outs.append(out))
    corr, mask = train.empty_patch_inputs(CFG, TOTAL)
    total, metrics = train.make_loss_fn(net, CFG)(torch.from_numpy(clouds), corr, mask)
    assert len(want_centers) == len(outs[0].center_idx_origin) == 4
    for want, got in zip(want_centers, outs[0].center_idx_origin):
        np.testing.assert_array_equal(want, got.numpy())
    assert set(metrics) == set(want_metrics) == {"place_recognition", "total"}
    for key, value in want_metrics.items():
        np.testing.assert_allclose(metrics[key].item(), value, rtol=LOSS_RTOL, err_msg=key)
    assert total.item() > 0
    stats = _stats_of(net)
    jax_stats = _jax_stats(want_stats, stats)
    for name, got in stats.items():
        np.testing.assert_allclose(got, jax_stats[name], rtol=STATS_RTOL, atol=1e-6, err_msg=name)

    total.backward()
    # the head's JAX gradients carried into a model of the same shape
    carrier = load_jax_variables(get_model("pptnet", CFG).double(), {
        "params": {**rest, **want_grads}, "batch_stats": wide["batch_stats"]})
    held = 0
    for (name, p), q in zip(net.named_parameters(), carrier.parameters()):
        got = p.grad.numpy()
        assert np.isfinite(got).all(), name
        if name.startswith("aggregation."):
            want = q.detach().numpy()
            # vlad0 has one cluster: its assignment is 1 whatever the weights
            assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want), name
            held += 1
    assert held == len(jax.tree_util.tree_leaves(want_grads))
