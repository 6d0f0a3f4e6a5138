"""The port's miners and auxiliary losses against the JAX package, on the CPU.

``batch_hard_triplet_loss``, ``batch_hard_contrastive_loss``,
``contrastive_quadruplet_loss``, ``ot_loss``, ``pps_loss``,
``multi_similarity_loss``, ``binary_focal_loss`` and ``focal_loss``: the
same seeded numpy inputs through the JAX function and the port, the value
(and every statistic) and the gradients against ``jax.value_and_grad``.
The inputs hold the cases the masked forms exist for: anchors without a
positive or a negative, tied distances (duplicate embeddings, duplicate
candidates) where the first index must win, violated and satisfied
quadruplets, batch elements without valid pairs, groups that keep no
negative, and a label 0 the focal loss ignores.

Tolerances, each beside the largest difference measured on the CPU:
values and float statistics 1e-5 relative (measured 2.3e-7, the
quadruplet loss; the mined losses at d = 16, whose distances take the
matrix form, 1.5e-7), integer statistics exactly, gradients 1e-5 relative
plus 1e-6 absolute per element (measured 4.5e-8 absolute).

The JAX oracles compile with XLA's optimisations and the CPU fusion
emitters off (``_jit``).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import losses as jlosses

from patchaugnet_tpu_torch import losses

VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


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


def _both(port_fn, jax_fn, floats, others=(), **kw):
    """The port's and JAX's value (and statistics) with the gradients of
    the value with respect to every array in ``floats``; ``others`` are
    passed as they are (masks, index tables) after them."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in floats]
    out = port_fn(*ts, *[torch.from_numpy(o) for o in others], **kw)
    loss = out[0] if isinstance(out, tuple) else out
    loss.backward()

    def scalar(*fa):
        res = jax_fn(*fa, *[jnp.asarray(o) for o in others], **kw)
        return (res[0], res[1]) if isinstance(res, tuple) else (res, {})

    (jloss, jstats), jgrads = _jit(jax.value_and_grad(scalar, argnums=tuple(range(len(floats))), has_aux=True))(
        *[jnp.asarray(a) for a in floats])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=VALUE_RTOL)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if isinstance(out, tuple):
        stats = out[1]
        assert stats.keys() == jstats.keys()
        for key, value in stats.items():
            want = np.asarray(jstats[key])
            if np.issubdtype(want.dtype, np.integer):
                assert value.item() == int(want), key
            else:
                np.testing.assert_allclose(value.item(), float(want), rtol=VALUE_RTOL, err_msg=key)
    return loss.item()


def _mining_batch(seed, n=12, d=16):
    """Embeddings with rows 1 and 2 equal (tied distances from every other
    anchor), positives within blocks of four, negatives across blocks;
    anchor 10 has no positive and anchor 0 no negative."""
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, d).astype(np.float32) * 0.4
    emb[2] = emb[1]
    block = np.arange(n) // 4
    pos = (block[:, None] == block[None, :]) & ~np.eye(n, dtype=bool)
    neg = block[:, None] != block[None, :]
    pos[10], pos[:, 10] = False, False
    neg[0] = False
    return emb, pos, neg


@pytest.mark.parametrize("which", ["triplet", "contrastive"])
def test_batch_hard_losses(which):
    emb, pos, neg = _mining_batch(0)
    if which == "triplet":
        value = _both(losses.batch_hard_triplet_loss, jlosses.batch_hard_triplet_loss, [emb], [pos, neg], margin=0.5)
    else:
        value = _both(losses.batch_hard_contrastive_loss, jlosses.batch_hard_contrastive_loss, [emb], [pos, neg],
                      pos_margin=0.2, neg_margin=2.0)
    assert value > 0


def test_mined_indices_take_the_first_of_tied():
    """Rows 1 and 2 are equal and far from everything: they are the
    hardest positives of anchors 0 and 3, tied, and index 1 wins."""
    from patchaugnet_tpu.losses.miners import _mine_hard as jmine
    from patchaugnet_tpu_torch.losses.miners import _mine_hard

    emb, pos, neg = _mining_batch(0)
    emb[1] = emb[2] = 5.0                                   # the farthest from every anchor
    got = _mine_hard(torch.from_numpy(emb), torch.from_numpy(pos), torch.from_numpy(neg))
    want = jmine(jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(neg))
    for i in (2, 4, 5):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert got[2][0] == 1 and got[2][3] == 1


@pytest.mark.parametrize("use_min,lazy,ignore_zero_loss", [(False, True, False), (True, False, True),
                                                            (False, False, True)])
def test_contrastive_quadruplet_loss(use_min, lazy, ignore_zero_loss):
    rng = np.random.RandomState(1)
    b, d = 6, 16
    q = rng.randn(b, 1, d).astype(np.float32)
    pos = (q + rng.randn(b, 2, d) * np.linspace(0.2, 1.6, b)[:, None, None]).astype(np.float32)
    neg = (q + rng.randn(b, 5, d) * 1.0).astype(np.float32)
    other = rng.randn(b, 1, d).astype(np.float32)
    positive = ((pos - q) ** 2).sum(2).max(1)
    violated = ((neg - q) ** 2).sum(2).min(1) < positive
    assert violated.any() and not violated.all(), "the batch must hold violated and satisfied quadruplets"
    _both(lambda *a: losses.contrastive_quadruplet_loss(*a, 0.5, 0.2, use_min=use_min, lazy=lazy,
                                                        ignore_zero_loss=ignore_zero_loss),
          lambda *a: jlosses.contrastive_quadruplet_loss(*a, 0.5, 0.2, use_min=use_min, lazy=lazy,
                                                         ignore_zero_loss=ignore_zero_loss),
          [q, pos, neg, other])


@pytest.mark.parametrize("use_unpair", [True, False])
def test_ot_loss(use_unpair):
    rng = np.random.RandomState(2)
    b, m, n, p, u = 3, 8, 10, 6, 4
    scores = rng.randn(b, m + 1, n + 1).astype(np.float32)
    pair_idx = np.stack([rng.randint(0, m, (b, p)), rng.randint(0, n, (b, p))], -1).astype(np.int32)
    pair_valid = rng.rand(b, p) < 0.6
    pair_valid[2] = False                                   # no valid pair in element 2
    unpair0 = rng.randint(0, m, (b, u)).astype(np.int32)
    unpair1 = rng.randint(0, n, (b, u)).astype(np.int32)
    u0_valid = rng.rand(b, u) < 0.5
    u0_valid[0] = False
    u1_valid = rng.rand(b, u) < 0.5
    _both(lambda s, *a: losses.ot_loss(s, *a, use_unpair=use_unpair),
          lambda s, *a: jlosses.ot_loss(s, *a, use_unpair=use_unpair),
          [scores], [pair_idx, pair_valid, unpair0, u0_valid, unpair1, u1_valid])


def test_pps_loss():
    """Row candidates repeat an index (a tie at the nearest), and invalid rows."""
    rng = np.random.RandomState(3)
    b, m, d, r, k = 2, 10, 8, 7, 4
    src = rng.randn(b, m, d).astype(np.float32)
    tgt = rng.randn(b, m, d).astype(np.float32)
    idx = rng.randint(0, m, (b, r, 2 + k)).astype(np.int32)
    idx[:, :, 3] = idx[:, :, 2]
    valid = rng.rand(b, r) < 0.7
    _both(lambda s, t, *a: losses.pps_loss(s, t, *a, margin=1.5),
          lambda s, t, *a: jlosses.pps_loss(s, t, *a, margin=1.5), [src, tgt], [idx, valid])


@pytest.mark.parametrize("rank", [3, 2])
def test_multi_similarity_loss(rank):
    rng = np.random.RandomState(4)
    shape = (3, 5, 8) if rank == 3 else (5, 8)
    a = rng.randn(*shape).astype(np.float32)
    p = (a + rng.randn(*shape) * 0.5).astype(np.float32)
    n = rng.randn(*shape).astype(np.float32)
    if rank == 3:
        n[1] = -a[1]                                        # a group that keeps no negative
    _both(losses.multi_similarity_loss, jlosses.multi_similarity_loss, [a, p, n])


@pytest.mark.parametrize("with_logit", [True, False])
def test_binary_focal_loss(with_logit):
    rng = np.random.RandomState(5)
    logits = rng.randn(4, 7).astype(np.float32) if with_logit else rng.uniform(0.02, 0.98, (4, 7)).astype(np.float32)
    target = (rng.rand(4, 7) < 0.4).astype(np.int32)
    _both(lambda x, t: losses.binary_focal_loss(x, t, with_logit=with_logit),
          lambda x, t: jlosses.binary_focal_loss(x, t, with_logit=with_logit), [logits], [target])


def test_focal_loss():
    rng = np.random.RandomState(6)
    logits = rng.randn(10, 5).astype(np.float32)
    target = rng.randint(0, 5, 10).astype(np.int32)
    target[:3] = 0                                          # ignored
    _both(losses.focal_loss, jlosses.focal_loss, [logits], [target])
