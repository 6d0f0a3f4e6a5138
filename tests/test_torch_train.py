"""The port's train step against the JAX package, on the CPU.

A JAX ``PatchAugNet`` at a tiny configuration (128 points, SAMPLING
[32, 8, 4], KNN [8, 8, 4], a tuple batch of 2 x (1 + 1 + 2 + 1) = 10
clouds, a2b tables of 64 rows and 4 pairs) is initialised with patches,
its BN statistics replaced by random numpy values, and carried into the
port with ``load_jax_variables``; both take the same numpy clouds,
cloud mask and correspondence tables. The JAX side jits
``value_and_grad(make_loss_fn)`` once and applies optax in Python for
both trajectory steps.

Indices are exactly equal. Float tolerances, each beside the largest
difference measured on the CPU:
- train-mode BatchNorm output, alone and in the NetVLAD, AFA and gating
  heads: 2e-6 absolute and relative (measured 4.8e-7 absolute), its new
  running statistics 2e-6 relative (the heads' within STATS_RTOL);
- the decoder: 2e-6 absolute in train mode (measured 7.5e-7), 1e-6 in
  eval mode (5.5e-7);
- the backward of the BatchNorm, the decoder and the heads, with respect
  to the input and every parameter: GRAD_TOL, 5e-6 of the largest
  gradient magnitude (measured 7.9e-7);
- the whole loss's gradient, leaf by leaf: see
  ``test_loss_gradients_match_jax``;
- metric and patch losses and their input gradients: 1e-6 relative
  (measured 6.0e-8);
- ``make_loss_fn`` and the trajectory's first step: metrics 5e-5
  relative (the place-recognition term measured 9.8e-6: its hinge sits
  on distances between near-equal descriptors after train-mode
  BatchNorms over 10 clouds), new batch statistics 2e-5 relative plus
  1e-6 absolute (the largest difference measured is 22% of that bound,
  9.5e-7 at most); the second step: see its test;
- the optimizers against optax on given gradients, on the parameters:
  SGD 1e-6 absolute (measured 2.4e-7); Adam 1e-5 (measured 3.0e-6 after
  12 updates at a learning rate of 0.05: optax forms its bias correction
  ``1 - 0.999 ** t`` in f32, torch in f64, 6.5e-6 apart in the update at
  t = 1 and less after); a resumed Adam update 1e-6 (measured 1.2e-7).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from patchaugnet_tpu import losses as jlosses
from patchaugnet_tpu import train as jtrain
from patchaugnet_tpu.losses.patch_contrast import PatchCorrespondences as JaxCorrespondences
from patchaugnet_tpu.models import get_model as jax_get_model
from patchaugnet_tpu.nn.core import batch_norm as jax_batch_norm
from patchaugnet_tpu.nn.attention import AdaptiveFeatureAggregator as JaxAFA
from patchaugnet_tpu.nn.pointnet import PointNetDecoder as JaxPointNetDecoder
from patchaugnet_tpu.nn.vlad import GatingContext as JaxGatingContext
from patchaugnet_tpu.nn.vlad import NetVLADBase as JaxNetVLADBase

from patchaugnet_tpu_torch import configs, losses, train
from patchaugnet_tpu_torch.compat import load_jax_opt_state, load_jax_variables
from patchaugnet_tpu_torch.losses import PatchCorrespondences
from patchaugnet_tpu_torch.models import get_model
from patchaugnet_tpu_torch.nn import (AdaptiveFeatureAggregator, BatchNorm, GatingContext, NetVLADBase,
                                      PointNetDecoder)

CFG = dict(configs.PATCH_AUG_NET_TRAIN, NUM_POINTS=128, SAMPLING=[32, 8, 4], KNN=[8, 8, 4],
           MAX_SAMPLES=[8, 32, 128], TRAIN_BATCH_SIZE=2, TRAIN_POSITIVES_PER_QUERY=1,
           TRAIN_NEGATIVES_PER_QUERY=2, BASE_LEARNING_RATE=1e-3, MAX_EPOCH=2, A2B_MAX_ROWS=64,
           A2B_MAX_PAIRS=4)
TUPLE = 1 + 1 + 2 + 1
TOTAL = CFG["TRAIN_BATCH_SIZE"] * TUPLE
LOSS_RTOL = 5e-5
STATS_RTOL = 2e-5
STEP2_RTOL = 1e-2                  # the trajectory's second step, see its test
GRAD_TOL = 5e-6                    # module gradients, of their largest magnitude
OPT_ATOL = {"adam": 1e-5, "momentum": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are small, and a thread pool per
    test process spins against the other pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _tables(rng):
    """Correspondence tables (numpy) over the flat batch: pair 0 between
    query 0 and positive 1, pair 1 between query 5 and positive 6, about
    half the rows valid; pair 2 has rows but none valid, pair 3 none at
    all; three valid rows of pair 0 name a negative cloud (2), outside the
    patch subset, and must drop out."""
    t = CFG["A2B_MAX_ROWS"]
    pair = rng.randint(0, 3, t).astype(np.int32)
    q_cloud = np.where(pair == 1, 5, 0).astype(np.int32)
    n_cloud = q_cloud + 1
    valid = (rng.rand(t) < 0.5) & (pair != 2)
    n_cloud[np.flatnonzero(valid & (pair == 0))[:3]] = 2
    m = CFG["SAMPLING"][0]
    slots = [rng.randint(0, m, t).astype(np.int32) for _ in range(3)]
    return (q_cloud, n_cloud, *slots, pair, valid)


def _jax_corr(tables):
    return JaxCorrespondences(*(jnp.asarray(a) for a in tables), CFG["A2B_MAX_PAIRS"])


def _port_corr(tables):
    return PatchCorrespondences(*(torch.from_numpy(np.array(a)) for a in tables), CFG["A2B_MAX_PAIRS"])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def run():
    """The JAX side, computed once: the batch, the initial variables, and
    two steps of the JAX loss with the optax update between them."""
    rng = np.random.RandomState(0)
    clouds = rng.rand(TOTAL, CFG["NUM_POINTS"], 3).astype(np.float32)
    mask = np.zeros(TOTAL, bool)
    mask[[0, 1, 5, 6]] = True                                 # queries and positives
    tables = _tables(rng)
    model = jax_get_model("patch_aug_net", CFG)
    state = jtrain.create_train_state(model, jax.random.PRNGKey(0), jnp.asarray(clouds), CFG,
                                      steps_per_epoch=1, init_kwargs={"with_patches": True})
    variables = {"params": _np(state.params),
                 "batch_stats": _random_batch_stats(_np(state.batch_stats), rng)}
    grad_fn = jax.jit(jax.value_and_grad(jtrain.step.make_loss_fn(model, CFG), has_aux=True))

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = state.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, stats, opt_state = state.params, variables["batch_stats"], state.opt_state
    steps, first_grads = [], None
    for _ in range(2):
        (total, (metrics, stats)), grads = grad_fn(params, stats, jnp.asarray(clouds),
                                                   _jax_corr(tables), jnp.asarray(mask))
        steps.append(({k: float(v) for k, v in metrics.items()}, _np(stats)))
        first_grads = _np(grads) if first_grads is None else first_grads
        params, opt_state = update(grads, opt_state, params)
    return dict(clouds=clouds, mask=mask, tables=tables, variables=variables, steps=steps,
                grads=first_grads, params=params, opt_state=opt_state, update=update)


def _port_state(run):
    model = load_jax_variables(get_model("patch_aug_net", CFG), run["variables"])
    return train.create_train_state(model, CFG, steps_per_epoch=1, device="cpu")


def _stats_of(model):
    """The model's running statistics as the JAX tree's leaves."""
    return {tuple(name.split(".")[:-1]) + ({"running_mean": "mean", "running_var": "var"}[name.split(".")[-1]],):
            t.detach().numpy() for name, t in model.named_buffers()}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _assert_stats(model, jax_stats, rtol=None):
    """Every running statistic elementwise (``rtol=None``: STATS_RTOL), or
    each leaf within ``rtol`` in relative L2 norm."""
    ours = _stats_of(model)
    assert len(ours) == sum(1 for _ in jax.tree_util.tree_leaves(jax_stats))
    for path, got in ours.items():
        want = _leaf(jax_stats, path)
        if rtol is None:
            np.testing.assert_allclose(got, want, rtol=STATS_RTOL, atol=1e-6, err_msg="/".join(path))
        else:
            assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want), "/".join(path)


def _assert_metrics(got, want, rtol=LOSS_RTOL):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].item(), value, rtol=rtol, atol=1e-7, err_msg=key)


def _jax_with_grads(apply, variables, x, w):
    """One JAX forward and backward of ``apply(variables, x) -> (out,
    mutated)``: ``out``, ``mutated``, and the gradients of ``sum(out * w)``
    with respect to the parameters and the input."""
    def loss(params, x):
        out, mutated = apply({"params": params, "batch_stats": variables["batch_stats"]}, x)
        return jnp.sum(out * w), (out, mutated)

    (_, (out, mutated)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    return out, mutated, gp, gx


def _assert_module_grads(got, w, xt, gx, module, fresh, gp, batch_stats):
    """The port's gradients of ``sum(got * w)`` (``got`` came from ``xt``
    through ``module``) against the JAX ones, ``gx`` and ``gp``; ``fresh``,
    a new port module of the same shape, carries ``gp``."""
    (got * torch.from_numpy(w)).sum().backward()
    carrier = load_jax_variables(fresh, {"params": _np(gp), "batch_stats": batch_stats})
    _assert_grads([("input", xt.grad, gx)] + [(name, p.grad, g.detach()) for (name, p), g in
                                              zip(module.named_parameters(), carrier.parameters())])


def _assert_grads(pairs):
    """Each ``(name, got, want)`` gradient elementwise within GRAD_TOL of
    the largest magnitude among all of them (a bias ahead of a train-mode
    BatchNorm has a true gradient of zero, and the two packages' rounding
    noise there is no relative measure)."""
    scale = max(np.abs(np.asarray(want)).max() for _, _, want in pairs)
    for name, got, want in pairs:
        err = np.abs(np.asarray(got) - np.asarray(want)).max() / scale
        assert err <= GRAD_TOL, (name, err)


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("shape", [(6, 5), (3, 7, 5), (2, 4, 3, 5)])
def test_batch_norm_train_matches_flax(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    c = shape[-1]
    variables = {"params": {"scale": rng.rand(c).astype(np.float32) + 0.5,
                            "bias": rng.randn(c).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(c).astype(np.float32),
                                 "var": rng.rand(c).astype(np.float32) + 0.5}}
    bn = BatchNorm(c)
    with torch.no_grad():
        for name, value in (("weight", "scale"), ("bias", "bias")):
            getattr(bn, name).copy_(torch.from_numpy(variables["params"][value]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    w = rng.randn(*shape).astype(np.float32)
    want, mutated, gp, gx = _jax_with_grads(
        lambda v, x: jax_batch_norm().apply(v, x, use_running_average=False, mutable=["batch_stats"]),
        variables, x, w)
    xt = torch.from_numpy(x).requires_grad_()
    got = bn.train()(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), rtol=2e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]), rtol=2e-6)
    # the backward, through the batch statistics
    (got * torch.from_numpy(w)).sum().backward()
    _assert_grads([("input", xt.grad, gx)] + [(name, getattr(bn, name).grad, gp[value])
                                              for name, value in (("weight", "scale"), ("bias", "bias"))])
    before = bn.running_mean.clone()
    bn.eval()(torch.from_numpy(x))
    assert torch.equal(bn.running_mean, before)            # eval mode leaves them


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_decoder_matches_jax(mode):
    rng = np.random.RandomState(3)
    z = rng.randn(12, 16).astype(np.float32)
    jd = JaxPointNetDecoder(embedding_size=16, num_points=5)
    variables = _np(jd.init(jax.random.PRNGKey(1), jnp.asarray(z)))
    variables["batch_stats"] = _random_batch_stats(variables["batch_stats"], rng)
    w = rng.randn(12, 5, 3).astype(np.float32)
    want, mutated, gp, gx = _jax_with_grads(
        lambda v, x: jd.apply(v, x, train=mode == "train", mutable=["batch_stats"]), variables, z, w)
    dec = load_jax_variables(PointNetDecoder(16, 5), variables)
    zt = torch.from_numpy(z).requires_grad_()
    got = dec.train(mode == "train")(zt)
    assert got.shape == (12, 5, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6 if mode == "train" else 1e-6)
    for bn in ("bn1", "bn2"):
        np.testing.assert_allclose(getattr(dec, bn).running_var.numpy(),
                                   np.asarray(mutated["batch_stats"][bn]["var"]), rtol=2e-6)
    _assert_module_grads(got, w, zt, gx, dec, PointNetDecoder(16, 5), gp, variables["batch_stats"])


_HEADS = {
    # NetVLAD bn1 reduces over (B, N) of its (B, N, K) activations, the AFA
    # bn and gating bn1 over the batch alone (torch's unbiased update would
    # differ there by B / (B - 1))
    "netvlad": (lambda: JaxNetVLADBase(feature_size=8, cluster_size=4), lambda: NetVLADBase(8, 4), (5, 12, 8),
                (5, 8, 4)),
    "afa": (lambda: JaxAFA(c_in=8, k=4, c_out=6), lambda: AdaptiveFeatureAggregator(8, 4, 6), (5, 4, 8), (5, 6)),
    "gating": (lambda: JaxGatingContext(dim=8), lambda: GatingContext(8), (5, 8), (5, 8)),
}


@pytest.mark.parametrize("head", list(_HEADS))
def test_head_batch_norms_train_matches_jax(head):
    """The heads' train-mode BatchNorms: output, new running statistics and
    gradients against the JAX module's on carried-over weights."""
    jax_module, port_module, shape, out_shape = _HEADS[head]
    rng = np.random.RandomState(9)
    x = rng.randn(*shape).astype(np.float32)
    jm = jax_module()
    variables = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    variables["batch_stats"] = _random_batch_stats(variables["batch_stats"], rng)
    w = rng.randn(*out_shape).astype(np.float32)
    want, mutated, gp, gx = _jax_with_grads(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]),
                                            variables, x, w)
    module = load_jax_variables(port_module(), variables).train()
    xt = torch.from_numpy(x).requires_grad_()
    got = module(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)
    _assert_stats(module, mutated["batch_stats"])
    _assert_module_grads(got, w, xt, gx, module, port_module(), gp, variables["batch_stats"])


# ---------------------------------------------------------------- losses
def _descriptors(rng, b=3, p=2, n=4, d=8):
    q = rng.randn(b, 1, d).astype(np.float32) * 0.3
    pos = q + rng.randn(b, p, d).astype(np.float32) * 0.2
    neg = rng.randn(b, n, d).astype(np.float32) * 0.3
    neg[0] += 3.0                                             # query 0: every hinge at zero
    other = rng.randn(b, 1, d).astype(np.float32) * 0.3
    return q, pos, neg, other


_LOSS_CASES = [
    ("quadruplet", dict(lazy=True)),
    ("quadruplet", dict(lazy=False)),
    ("quadruplet", dict(lazy=False, use_min=True, ignore_zero_loss=True)),
    ("quadruplet", dict(lazy=True, soft_margin=True)),
    ("quadruplet", dict(lazy=False, ignore_zero_loss=True, soft_margin=True)),
    ("triplet", dict(lazy=True)),
    ("triplet", dict(lazy=False, use_min=True, ignore_zero_loss=True)),
    ("hphn_quadruplet", dict(lazy=True)),
]


@pytest.mark.parametrize("name,flags", _LOSS_CASES)
def test_metric_losses_match_jax(name, flags):
    """Value and gradients with respect to every input, through the
    string dispatch of both packages."""
    inputs = _descriptors(np.random.RandomState(4))
    jfn, fn = jlosses.get_loss_func(name), losses.get_loss_func(name)
    assert fn.__name__ == jfn.__name__

    def jax_loss(*xs):
        return jfn(*xs, 0.5, 0.2, **flags)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, inputs))
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = fn(*xs, 0.5, 0.2, **flags)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for x, g in zip(xs, want_grads):
        grad = np.zeros(x.shape, np.float32) if x.grad is None else x.grad.numpy()
        np.testing.assert_allclose(grad, np.asarray(g), rtol=1e-6, atol=1e-7)


def test_best_pos_distance_matches_jax():
    q, pos, _, _ = _descriptors(np.random.RandomState(5))
    want = jlosses.best_pos_distance(jnp.asarray(q), jnp.asarray(pos))
    got = losses.best_pos_distance(torch.from_numpy(q), torch.from_numpy(pos))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_patch_contrastive_loss_matches_jax():
    """Invalid rows and pairs without valid rows drop out; each valid
    pair's term equals the per-pair oracle ``contrastive_loss``."""
    rng = np.random.RandomState(6)
    feats = rng.randn(4, 20, 8).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    t = 40
    pair = rng.randint(0, 3, t).astype(np.int32)
    q_cloud = (2 * (pair == 1)).astype(np.int32)
    valid = (rng.rand(t) < 0.6) & (pair != 2)
    tables = (q_cloud, q_cloud + 1, *(rng.randint(0, 20, t).astype(np.int32) for _ in range(3)), pair, valid)
    want, want_grad = jax.value_and_grad(jlosses.patch_contrastive_loss)(
        jnp.asarray(feats), JaxCorrespondences(*(jnp.asarray(a) for a in tables), 4), 0.5)
    x = torch.from_numpy(feats).requires_grad_()
    got = losses.patch_contrastive_loss(x, PatchCorrespondences(*map(torch.from_numpy, tables), 4), 0.5)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)

    per_pair = []
    for p in (0, 1):
        rows = np.flatnonzero(valid & (pair == p))
        f = torch.from_numpy(feats)
        per_pair.append(losses.contrastive_loss(
            f[q_cloud[rows], tables[2][rows]], f[q_cloud[rows] + 1, tables[3][rows]],
            f[q_cloud[rows] + 1, tables[4][rows]], 0.5))
    np.testing.assert_allclose(got.item(), float(sum(per_pair)) / 2, rtol=1e-6)

    empty = PatchCorrespondences.empty(16, 4)
    assert empty.row_valid.dtype == torch.bool and empty.row_q_cloud.dtype == torch.int32
    assert losses.patch_contrastive_loss(torch.from_numpy(feats), empty, 0.5).item() == 0.0


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_optimizer_and_schedule_match_optax(optimizer):
    """Twelve updates on given gradients across the StepLR boundary at
    step 10 (one step per epoch), with the zero-loss gate at update 3
    (non-zero moments by then) and a parameter left without a gradient at
    update 5, against optax's update of the same tree."""
    cfg = dict(CFG, OPTIMIZER=optimizer, MAX_EPOCH=20, BASE_LEARNING_RATE=0.05)
    rng = np.random.RandomState(7)
    init = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    holder = torch.nn.Module()
    for key, value in init.items():
        setattr(holder, key, torch.nn.Parameter(torch.from_numpy(value.copy())))
    state = train.create_train_state(holder, cfg, steps_per_epoch=1, device="cpu")
    schedule = jtrain.make_schedule("step", 0.05, 1, 20)
    tx = jtrain.make_optimizer(optimizer, schedule, 0.9)
    params = jax.tree.map(jnp.asarray, init)
    opt_state = tx.init(params)
    for i in range(12):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        keep = i != 3
        if i == 5:
            grads["b"] = np.zeros_like(grads["b"])            # autograd leaves b without a gradient
        jgrads = {k: jnp.asarray(v if keep else np.zeros_like(v)) for k, v in grads.items()}
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        holder.a.grad = torch.from_numpy(grads["a"])
        holder.b.grad = None if i == 5 else torch.from_numpy(grads["b"])
        state.apply_gradients(keep=torch.tensor(keep))
        for key in init:
            np.testing.assert_allclose(getattr(holder, key).detach().numpy(), np.asarray(params[key]),
                                       atol=OPT_ATOL[optimizer], err_msg=f"{key} after update {i}")
    assert state.step == 12


def test_schedules_match_optax():
    for decay in ("step", "cosine", "none"):
        for spe, max_epoch in ((1, 30), (7, 30), (3, 5)):
            ours = train.make_schedule(decay, 5e-4, spe, max_epoch)
            theirs = jtrain.make_schedule(decay, 5e-4, spe, max_epoch)
            for count in range(0, 40 * spe, max(spe // 2, 1)):
                np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6,
                                           err_msg=f"{decay} spe={spe} count={count}")


def test_load_jax_opt_state_resumes_adam(run):
    """The JAX trajectory's parameters and Adam state after its two
    updates, carried into the port: a third update on the same gradients
    gives the same parameters."""
    rng = np.random.RandomState(8)
    params, opt_state = run["params"], run["opt_state"]
    grads = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
    want, _ = run["update"](grads, opt_state, params)
    stats = run["variables"]["batch_stats"]
    state = _port_state(run)
    load_jax_variables(state.model, {"params": _np(params), "batch_stats": stats})
    load_jax_opt_state(state, _np(opt_state))
    assert state.step == 2
    carrier = load_jax_variables(get_model("patch_aug_net", CFG), {"params": _np(grads), "batch_stats": stats})
    for p, g in zip(state.model.parameters(), carrier.parameters()):
        p.grad = g.detach().clone()
    state.apply_gradients()
    ref = load_jax_variables(get_model("patch_aug_net", CFG), {"params": _np(want), "batch_stats": stats})
    for (name, got), p in zip(state.model.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), p.detach().numpy(), atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="Adam"):
        load_jax_opt_state(state, (optax.EmptyState(),))


# ------------------------------------------------------------ the step
def test_loss_fn_matches_jax(run):
    """Total, each weighted term and the new batch statistics of one
    train-mode loss against the JAX ``make_loss_fn`` on the same mask
    (so the same patch subset)."""
    state = _port_state(run)
    loss_fn = train.make_loss_fn(state.model, CFG)
    state.model.train()
    total, metrics = loss_fn(torch.from_numpy(run["clouds"]), _port_corr(run["tables"]),
                             torch.from_numpy(run["mask"]))
    want_metrics, want_stats = run["steps"][0]
    _assert_metrics(metrics, want_metrics)
    assert set(metrics) == {"place_recognition", "patch_recon_a2a", "patch_recon_a2b", "total"}
    assert all(v.item() > 0 for v in metrics.values())
    assert total is metrics["total"]
    _assert_stats(state.model, want_stats)


# Leaves of the whole loss's gradient, by how far JAX's own jitted and
# eager gradients of it lie apart in relative L2 (tests/grad_spread_probe.py
# on the CPU): the heads and the FP levels 1.5e-5 to 5.3e-3, like SA2's
# last layer; the decoder 0.085 to 0.19; the SA levels' other leaves 0.37
# to 0.94, where the loss's backward is dominated by rounding (train-mode
# BatchNorms over 10 clouds, the variance as E[x^2] - E[x]^2) and a
# comparison shows nothing. The biases ahead of a train-mode BatchNorm have
# a true gradient of zero.
_ZERO_GRAD_BIASES = {"decoder.fc1.bias", "decoder.fc2.bias", "aggregation.afa.fc.bias"}
LEAF_RTOL = {"stable": 3e-2, "decoder": 0.4}


def _leaf_group(name):
    if name in _ZERO_GRAD_BIASES:
        return "zero"
    if name.startswith(("aggregation.", "fp")) or name.startswith(("sa2.mlp.layer2.", "sa2.mlp.bn2.")):
        return "stable"
    return "decoder" if name.startswith("decoder.") else "sa"


def test_loss_gradients_match_jax(run):
    """The gradient of the whole loss, leaf by leaf in relative L2,
    against the JAX gradient on the same batch: the heads, the FP levels
    and SA2's last layer within 3e-2 (measured 1.5e-2 at the most, where
    JAX's own jitted and eager gradients lie up to 5.3e-3 apart), the
    decoder within 0.4 (measured 0.19, JAX's own spread 0.19), the biases
    ahead of a BatchNorm within 1e-6 of the whole gradient's norm; the SA
    levels' other leaves only finite (see ``_leaf_group``). A dropped or
    doubled term of the decoder, a BatchNorm or a level moves its leaves
    by 100%."""
    state = _port_state(run)
    state.model.train()
    total, _ = train.make_loss_fn(state.model, CFG)(torch.from_numpy(run["clouds"]), _port_corr(run["tables"]),
                                                   torch.from_numpy(run["mask"]))
    total.backward()
    carrier = load_jax_variables(get_model("patch_aug_net", CFG),
                                 {"params": run["grads"], "batch_stats": run["variables"]["batch_stats"]})
    pairs = [(name, p.grad.numpy(), q.detach().numpy())
             for (name, p), q in zip(state.model.named_parameters(), carrier.parameters())]
    whole = np.sqrt(sum(np.sum(want ** 2) for _, _, want in pairs))
    groups = set()
    for name, got, want in pairs:
        group = _leaf_group(name)
        groups.add(group)
        assert np.isfinite(got).all(), name
        err = np.linalg.norm(got - want)
        if group == "zero":
            assert err <= 1e-6 * whole, (name, err / whole)
        elif group != "sa":
            assert err <= LEAF_RTOL[group] * np.linalg.norm(want), (name, err / np.linalg.norm(want))
    assert groups == {"zero", "stable", "decoder", "sa"}


def test_train_step_trajectory_matches_jax(run):
    """Two steps of ``build_train_step`` on the CPU against the JAX loss at
    the JAX trajectory's parameters (optax Adam between the steps).

    The first step's metrics and new batch statistics hold to LOSS_RTOL
    and STATS_RTOL. The second's sit 2.5e-3 to 3.7e-3 apart in the patch
    terms, and the batch statistics up to 5.8e-3 in relative L2 per leaf:
    Adam's first update moves each parameter by the learning rate times
    the sign of its gradient, and in the SA levels' leaves 16-31% of those
    signs differ between the port and JAX, as 19-34% differ between JAX's
    own jitted and eager gradients of the same loss (measured on the CPU;
    the SA leaves' gradients are not assertable even within JAX, and
    ``test_loss_gradients_match_jax`` holds the others). So the second
    step holds to STEP2_RTOL: without the update it would repeat the
    first step's patch terms, 5% and 45% away.
    """
    state = _port_state(run)
    step = train.build_train_step(state.model, CFG)
    before = [p.detach().clone() for p in state.model.parameters()]
    for i, (want_metrics, want_stats) in enumerate(run["steps"]):
        state, metrics = step(state, run["clouds"], _port_corr(run["tables"]), run["mask"])
        assert state.step == i + 1 and state.model.training
        _assert_metrics(metrics, want_metrics, LOSS_RTOL if i == 0 else STEP2_RTOL)
        _assert_stats(state.model, want_stats, None if i == 0 else STEP2_RTOL)
    assert all(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_checkpoint_round_trip(run, tmp_path):
    state = _port_state(run)
    step = train.build_train_step(state.model, CFG)
    corr = _port_corr(run["tables"])
    state, _ = step(state, run["clouds"], corr, run["mask"])
    path = train.save_checkpoint(str(tmp_path), state, epoch=3, iteration=7)
    assert path.endswith("train_epoch_3_end")
    fresh = _port_state(run)
    restored, epoch = train.restore_checkpoint(path, fresh)
    assert epoch == 3 and restored.step == 1
    for (name, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    # the resumed run continues as the original does (Adam moments and count)
    _, want = step(state, run["clouds"], corr, run["mask"])
    _, got = train.build_train_step(restored.model, CFG)(restored, run["clouds"], corr, run["mask"])
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("trues,r", [([0, 1, 5, 6], 4), ([2, 7], 4), ([0, 3, 4, 8, 9], 3), ([], 2)])
def test_patch_subset_matches_jnp_nonzero(trues, r):
    """The step's patch subset, formed on the device, against
    ``jnp.nonzero(mask, size=r, fill_value=0)``: fewer true clouds than
    rows (the fill rows carry cloud 0), as many, and more."""
    from patchaugnet_tpu_torch.train.step import _first_true

    mask = np.zeros(TOTAL, bool)
    mask[trues] = True
    want = jnp.nonzero(jnp.asarray(mask), size=r, fill_value=0)[0]
    np.testing.assert_array_equal(_first_true(torch.from_numpy(mask), r).numpy(), np.asarray(want))


def test_center_fn_and_empty_inputs(run):
    centers = train.build_center_fn(CFG["SAMPLING"][0], device="cpu")(run["clouds"])
    want = jtrain.build_center_fn(CFG["SAMPLING"][0])(jnp.asarray(run["clouds"]))
    assert centers.dtype == torch.int32
    np.testing.assert_array_equal(centers.numpy(), np.asarray(want))
    corr, mask = train.empty_patch_inputs(CFG, TOTAL)
    jcorr, jmask = jtrain.empty_patch_inputs(CFG, TOTAL)
    assert corr.num_pairs == jcorr.num_pairs and mask.shape == jmask.shape and not mask.any()
    for a, b in zip(corr[:7], jcorr[:7]):
        assert a.shape == b.shape and not a.any()


def test_step_rejects_what_it_does_not_take(run):
    # REMAT is taken (tests/test_torch_precision.py)
    with pytest.raises(ValueError, match="decoder"):
        train.build_train_step(get_model("patch_aug_net", dict(CFG, use_patch_recon=False)), CFG)
