"""The port's ``nn/extras.py`` against the JAX package's, on the CPU, and
the public names of the port's ``ops``, ``nn`` and ``losses``.

Each block at B = 2, L = 12, d_model 16 (``tests/test_nn_extras.py``'s
sizes): the JAX variable tree's shapes come from ``jax.eval_shape`` of the
JAX module's init, every leaf is drawn from a numpy generator (BatchNorm
statistics and LayerNorm scales away from their defaults), the tree goes
into the port through ``load_jax_variables``, whose strict walk must take
it whole, and ``to_jax_variables`` must give the same tree back. Both
sides take the same numpy inputs; eval mode unless a test says otherwise.

Tolerance: outputs 1e-5 absolute (measured 6.7e-6, a single feature
processor; the attention blocks 9.5e-7: torch's LayerNorm takes the
variance in another way than flax's mean of squares, and the sums of the
products run in another order); the new BatchNorm statistics of CBAM's
spatial attention in train mode (flax momentum 0.99) the same (measured
1.8e-7); the positional embedding 1e-6 (measured 6.0e-8). Train-mode dropout draws from a torch generator, which cannot
reproduce a JAX mask: that mode is held for determinism under a seeded
generator and for flax's keep-rate scaling.

The JAX oracles compile with XLA's optimisations and the CPU fusion
emitters off (``_jit``).
"""
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import losses as jlosses
from patchaugnet_tpu import nn as jnn
from patchaugnet_tpu import ops as jops

from patchaugnet_tpu_torch import losses, nn, ops
from patchaugnet_tpu_torch.compat import load_jax_variables, to_jax_variables
from patchaugnet_tpu_torch.nn import extras

TOL = 1e-5
B, L, D = 2, 12, 16
# public names of the JAX package that the port carries under another name,
# each recorded in the docstring of the port's ``nn`` package
RENAMES = {"batch_norm": "BatchNorm", "nn_angle_jax": "nn_angle"}


def _jit(fn):
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


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


def _variables(jmodule, *args, seed=0, **kw):
    """The JAX module's variable tree with every leaf drawn from numpy."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if name in ("mean", "bias"):
            return (rng.randn(*leaf.shape) * 0.2).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.randn(*leaf.shape) * 0.2).astype(np.float32)
        fan = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[0]
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(lambda s: s, dict(shapes)))


def _carry(port, variables):
    """``variables`` into ``port`` (strict), and the tree back out equal."""
    load_jax_variables(port, variables)
    back = to_jax_variables(port)
    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)
    return port


def _pair(jmodule, port, *args, seed=0, **kw):
    """The JAX module's eval output and the port's, on the same weights."""
    jargs = [jnp.asarray(a) for a in args]
    variables = _variables(jmodule, *jargs, seed=seed, **kw)
    _carry(port, variables).eval()
    want = _jit(lambda v, *a: jmodule.apply(v, *a, **kw))(variables, *jargs)
    with torch.no_grad():
        got = port(*[_t(a) for a in args])
    return got, want


def _seq(seed, *shape):
    return np.random.RandomState(seed).randn(*(shape or (B, L, D))).astype(np.float32)


def test_public_names_match_the_jax_package():
    """Every public name of the JAX package's ``ops``, ``nn`` and
    ``losses`` is in the port's ``__all__``, save the renames that the
    port's ``nn`` docstring records."""
    for old, new in RENAMES.items():
        assert re.search(rf"`{old}`[^;.]*`{new}`", nn.__doc__), f"nn.__doc__ does not record {old} -> {new}"
    for jmod, mod in ((jops, ops), (jnn, nn), (jlosses, losses)):
        want = {RENAMES.get(name, name) for name in jmod.__all__}
        missing = sorted(want - set(mod.__all__))
        assert not missing, f"{mod.__name__} lacks {missing}"
        assert all(hasattr(mod, name) for name in mod.__all__)


@pytest.mark.parametrize("block", ["se", "channel", "cbam", "gem"])
def test_attention_blocks_and_gem(block):
    x = np.abs(_seq(1, B, 20, 32))
    jmod, port = {"se": (jnn.SEAttention(32, reduction=8), nn.SEAttention(32, reduction=8)),
                  "channel": (jnn.ChannelAttention(32, ratio=4), nn.ChannelAttention(32, ratio=4)),
                  "cbam": (jnn.CBAM(32, ratio=4), nn.CBAM(32, ratio=4)),
                  "gem": (jnn.GeMPooling(), nn.GeMPooling())}[block]
    got, want = _pair(jmod, port, x)
    _close(got, want)


def test_spatial_attention_train_mode():
    """Train mode: the batch statistics normalise and the running ones
    update with flax momentum 0.99; ``return_attn`` gives the weights."""
    x = _seq(2, B, 20, 8)
    jmod, port = jnn.SpatialAttention(), nn.SpatialAttention()
    variables = _variables(jmod, jnp.asarray(x))
    _carry(port, variables).train()
    (want, watt), new = _jit(lambda v, a: jmod.apply(v, a, train=True, return_attn=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    got, att = port(_t(x), return_attn=True)
    _close(got, want)
    _close(att, watt)
    _close(port.bn.running_mean, new["batch_stats"]["bn"]["mean"])
    _close(port.bn.running_var, new["batch_stats"]["bn"]["var"])
    assert port.bn.momentum == 0.99


def test_positional_embedding():
    idx = np.arange(7, dtype=np.float32) * 3.5
    _close(nn.sinusoidal_positional_embedding(_t(idx), 8),
           jnn.sinusoidal_positional_embedding(jnp.asarray(idx), 8), tol=1e-6)


@pytest.mark.parametrize("proj_k", [None, 4])
def test_multihead_attention_with_mask(proj_k):
    """The mask hides some keys of one element and all keys of the other
    (the Linformer form drops it)."""
    q, kv = _seq(3), _seq(4)
    mask = np.ones((B, L), bool)
    mask[0, 5:] = False
    mask[1] = False
    jmod = jnn.MultiheadAttention(D, 4, proj_k=proj_k)
    port = nn.MultiheadAttention(D, 4, proj_k=proj_k, seq_len=L)
    got, want = _pair(jmod, port, q, kv, kv, mask)
    _close(got, want)


@pytest.mark.parametrize("linear_attention_k", [None, 6])
def test_transformer_encoder_layer(linear_attention_k):
    src, pos = _seq(5), _seq(6)
    mask = np.ones((B, L), bool)
    mask[1, 8:] = False
    jmod = jnn.TransformerEncoderLayer(D, 4, dim_feedforward=32, linear_attention_k=linear_attention_k)
    port = nn.TransformerEncoderLayer(D, 4, dim_feedforward=32, linear_attention_k=linear_attention_k, seq_len=L)
    got, want = _pair(jmod, port, src, pos, mask)
    _close(got, want)
    # train mode: dropout from a seeded generator is deterministic, and differs from eval
    port.train()
    runs = [port(_t(src), _t(pos), _t(mask), generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert not torch.allclose(runs[0], got)


def test_dropout_keep_rate_scaling():
    """flax ``nn.Dropout``: kept elements scaled by 1 / (1 - rate), the
    rest zero, the keep share near 1 - rate."""
    x = torch.full((200, 100), 2.0)
    y = extras._dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert extras._dropout(x, 0.0, None) is x


def test_attentional_gnn_shares_modules_between_streams():
    x0, x1 = _seq(7, B, 10, D), _seq(8, B, L, D)
    jmod = jnn.AttentionalGNN(D, layer_types=("self", "cross"))
    port = nn.AttentionalGNN(D, layer_types=("self", "cross"))
    (g0, g1), (w0, w1) = _pair(jmod, port, x0, x1)
    _close(g0, w0)
    _close(g1, w1)


def _cloud(seed, n=L):
    pts = np.random.RandomState(seed).rand(B, n, 3).astype(np.float32)
    pts[:, 7] = pts[:, 2]                                   # a duplicate: a tie in the kNN
    return pts


def test_nn_angle():
    c = _cloud(9)
    _close(nn.nn_angle(_t(c), 3), jnn.nn_angle_jax(jnp.asarray(c), 3))


@pytest.mark.parametrize("encode_type", ["abs_coord", "nn_dist", "nn_angle", "dist_and_angle"])
def test_geo_encoders(encode_type):
    c = _cloud(10)
    got, want = _pair(jnn.GeoEncoder(encode_type, 8), nn.GeoEncoder(encode_type, 8, num_points=L), c)
    _close(got, want)


def test_distance_encoder_max_dist():
    c = _cloud(11)
    got, want = _pair(jnn.DistanceEncoder(8, max_dist=0.4), nn.DistanceEncoder(8, num_points=L, max_dist=0.4), c)
    _close(got, want)


CFG = {
    "embed_dim": D, "local_dim": 8, "global_dim": 8, "num_local": L,
    "cluster_size": 4, "use_geo_encoder": True,
    "geo_encode_type": "dist_and_angle", "add_or_cat": "cat",
    "use_vlad": True, "layer_names": ["self", "cross"],
    "use_pool": True, "pool": "gem",
}
PROCESSORS = {
    "gem": {},
    "avg unpooled vlad": {"use_pool": False},
    "max add no vlad": {"pool": "max", "add_or_cat": "add", "use_vlad": False, "local_dim": 8, "global_dim": 8},
    "avg none no gnn": {"pool": "avg", "add_or_cat": "none", "layer_names": [], "geo_encode_type": "nn_angle"},
}


def _processor_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 8).astype(np.float32), rng.rand(B, L, 8).astype(np.float32), _cloud(seed + 1))


@pytest.mark.parametrize("case", list(PROCESSORS))
def test_single_feat_processor(case):
    cfg = dict(CFG, **PROCESSORS[case])
    got, want = _pair(jnn.SingleFeatProcessor(cfg), nn.SingleFeatProcessor(cfg), *_processor_inputs(12))
    _close(got, want)
    assert nn.SingleFeatProcessor(cfg).out_dim == jnn.SingleFeatProcessor(cfg).out_dim


def test_pairwise_feat_processor():
    """Cross attention between the sets, on shared weights; the VLAD's
    BatchNorm takes the running statistics in train mode too, as the JAX
    processor calls it without ``train``."""
    port = nn.PairwiseFeatProcessor(CFG)
    (gx, gy), (wx, wy) = _pair(jnn.PairwiseFeatProcessor(CFG), port, *_processor_inputs(14), *_processor_inputs(16))
    _close(gx, wx)
    _close(gy, wy)
    port.train()
    assert not port.vlad.training and port.gnn_layer.training
    with torch.no_grad():
        tx, _ = port(*[_t(a) for a in _processor_inputs(14) + _processor_inputs(16)])
    _close(tx, wx)
