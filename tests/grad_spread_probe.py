"""How far the port's train-loss gradient lies from the JAX package's, leaf
by leaf, beside how far JAX's own jitted and eager gradients lie apart.

Runs the tiny configuration and batch of ``tests/test_torch_train.py``
(its ``run`` fixture's construction) on the CPU: one JAX ``value_and_grad``
of ``make_loss_fn`` jitted and one eager, one port backward of
``train.make_loss_fn``, all from the same variables. Prints, for every
parameter, ``||port - jit|| / ||jit||``, ``||eager - jit|| / ||jit||`` and
``||jit||``, then the largest of each per leaf group of that test's
``_leaf_group``. The test's LEAF_RTOL limits come from this table.

    python tests/grad_spread_probe.py      # about 2 minutes on one core
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import torch

import test_torch_train as T
from patchaugnet_tpu import train as jtrain
from patchaugnet_tpu.models import get_model as jax_get_model
from patchaugnet_tpu_torch import train
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.models import get_model


def main():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    clouds = rng.rand(T.TOTAL, T.CFG["NUM_POINTS"], 3).astype(np.float32)
    mask = np.zeros(T.TOTAL, bool)
    mask[[0, 1, 5, 6]] = True
    tables = T._tables(rng)
    model = jax_get_model("patch_aug_net", T.CFG)
    state = jtrain.create_train_state(model, jax.random.PRNGKey(0), jnp.asarray(clouds), T.CFG,
                                      steps_per_epoch=1, init_kwargs={"with_patches": True})
    variables = {"params": T._np(state.params),
                 "batch_stats": T._random_batch_stats(T._np(state.batch_stats), rng)}
    loss_fn = jax.value_and_grad(jtrain.step.make_loss_fn(model, T.CFG), has_aux=True)
    args = (state.params, variables["batch_stats"], jnp.asarray(clouds), T._jax_corr(tables), jnp.asarray(mask))
    _, jit_grads = jax.jit(loss_fn)(*args)
    with jax.disable_jit():
        _, eager_grads = loss_fn(*args)

    net = load_jax_variables(get_model("patch_aug_net", T.CFG), variables).train()
    total, _ = train.make_loss_fn(net, T.CFG)(torch.from_numpy(clouds), T._port_corr(tables),
                                              torch.from_numpy(mask))
    total.backward()

    def carried(grads):
        tree = {"params": T._np(grads), "batch_stats": variables["batch_stats"]}
        return [p.detach().numpy() for p in load_jax_variables(get_model("patch_aug_net", T.CFG), tree).parameters()]

    worst = {}
    for (name, p), jit, eager in zip(net.named_parameters(), carried(jit_grads), carried(eager_grads)):
        norm = np.linalg.norm(jit)
        port_rel = np.linalg.norm(p.grad.numpy() - jit) / max(norm, 1e-30)
        eager_rel = np.linalg.norm(eager - jit) / max(norm, 1e-30)
        print(f"{name:40s} port {port_rel:.2e}  eager {eager_rel:.2e}  norm {norm:.1e}")
        group = T._leaf_group(name)
        w = worst.setdefault(group, [0.0, 0.0])
        worst[group] = [max(w[0], port_rel), max(w[1], eager_rel)]
    for group, (port_rel, eager_rel) in sorted(worst.items()):
        print(f"GROUP {group}: port {port_rel:.2e} eager {eager_rel:.2e} (largest relative L2)")


if __name__ == "__main__":
    main()
