"""Carry the JAX package's weights into the port's modules.

``load_jax_variables(model, variables)`` takes a JAX variable tree
``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays
(for example ``jax.tree.map(np.asarray, variables)``, saved and loaded
without JAX) and fills the port's modules in place. The port's attribute
names follow the JAX tree, so the mapping is a walk over
``model.named_modules()``:

- ``nn.Linear`` at path P: ``params[P]["kernel"]`` (in, out) -> ``weight``
  (out, in); ``params[P]["bias"]`` -> ``bias``;
- ``BatchNorm`` at P: ``params[P]["scale"/"bias"]`` -> ``weight``/``bias``;
  ``batch_stats[P]["mean"/"var"]`` -> ``running_mean``/``running_var``;
- any other parameter ``name`` of a module at P: ``params[P][name]``.

It is strict: a missing key, a leaf of the tree that no module takes, or
a shape mismatch raises.

``load_jax_opt_state(state, opt_state)`` carries an optax Adam state
(``count``, ``mu``, ``nu``, trees shaped like ``params``, as numpy) into
the torch Adam of a ``train.TrainState`` by the same walk, so that a JAX
training run resumes in the port.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.core import BatchNorm

_LINEAR = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_BATCH_NORM = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,)


def _lookup(variables: Mapping[str, Any], path: Tuple[str, ...]):
    node = variables
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError(f"JAX variables missing: {'/'.join(path)}")
        node = node[key]
    return np.asarray(node)


def _tensors(model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor, bool]]:
    """Every parameter and buffer of ``model`` as (path in the JAX variable
    tree, tensor, whether the JAX leaf is its transpose)."""
    for mod_path, module in model.named_modules():
        prefix = tuple(mod_path.split(".")) if mod_path else ()
        if isinstance(module, nn.Linear):
            table = _LINEAR
        elif isinstance(module, BatchNorm):
            table = _BATCH_NORM
        else:
            table = {}
        own = [*module.named_parameters(recurse=False), *module.named_buffers(recurse=False)]
        for name, tensor in own:
            collection, key = table.get(name, ("params", name))
            yield (collection,) + prefix + (key,), tensor, isinstance(module, nn.Linear) and name == "weight"


def _value(tree: Mapping[str, Any], path: Tuple[str, ...], tensor: torch.Tensor, transpose: bool) -> torch.Tensor:
    value = _lookup(tree, path)
    if transpose:
        value = value.T
    if tuple(value.shape) != tuple(tensor.shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)} does not fit {tuple(tensor.shape)}")
    return torch.from_numpy(np.array(value)).to(device=tensor.device, dtype=tensor.dtype)


def _check_all_taken(tree: Mapping[str, Any], used, what: str) -> None:
    unused = sorted("/".join(p) for p in _leaves(tree) if p not in used)
    if unused:
        raise ValueError(f"{what} not taken by any module: {unused}")


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Copy ``variables`` into ``model`` (strict); returns ``model``."""
    used = set()
    for path, tensor, transpose in _tensors(model):
        tensor.copy_(_value(variables, path, tensor, transpose))
        used.add(path)
    _check_all_taken(variables, used, "JAX variables")
    return model


def _adam_state(opt_state) -> Tuple[int, Mapping[str, Any], Mapping[str, Any]]:
    """(count, mu, nu) of optax's ``ScaleByAdamState``, found in the chain's
    state (a tuple, as ``optax.adam`` makes it) or given as it is."""
    for node in (opt_state, *(opt_state if isinstance(opt_state, (tuple, list)) else ())):
        if all(hasattr(node, key) for key in ("count", "mu", "nu")):
            return int(np.asarray(node.count)), node.mu, node.nu
    raise ValueError("opt_state holds no Adam state (count, mu, nu)")


@torch.no_grad()
def load_jax_opt_state(state, opt_state):
    """Carry optax's Adam state into ``state.optimizer`` (a torch Adam):
    per parameter ``step`` = count, ``exp_avg`` = mu, ``exp_avg_sq`` = nu;
    ``state.step`` = count too, since optax's schedule counts the same
    updates. Strict, as :func:`load_jax_variables`. Returns ``state``."""
    if not isinstance(state.optimizer, torch.optim.Adam):
        raise TypeError(f"expected a torch Adam, got {type(state.optimizer).__name__}")
    count, mu, nu = _adam_state(opt_state)
    used = set()
    for path, param, transpose in _tensors(state.model):
        if path[0] != "params":
            continue
        state.optimizer.state[param] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _value(mu, path[1:], param, transpose),
            "exp_avg_sq": _value(nu, path[1:], param, transpose),
        }
        used.add(path[1:])
    _check_all_taken(mu, used, "Adam moments")
    state.step = count
    return state
