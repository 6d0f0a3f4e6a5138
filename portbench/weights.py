"""The benchmark's weight initialiser: every parameter and statistic of a
model, by name and shape, from the run's seed, on the device, in two
large random calls.

Both the port and the plain reference take these tensors: the port
through ``load_state_dict``, the reference by name. The rule, by the
name's last part and the shape:

- ``running_var`` and a 1-d ``weight`` (a norm's scale): uniform in
  [0.5, 1.5];
- ``bias`` and ``running_mean``: normal with std 0.1;
- any other tensor: normal with std ``1 / sqrt(fan)``, where the fan is
  the input width of a 2-d ``weight`` (``(out, in)``), else the
  configuration's ``init_fan`` for that name's last part (a number, or
  ``"rows"``: the product of every axis but the last), else the
  second-to-last axis.

The statistics sit away from 0 and 1 so that an eval forward exercises
every BatchNorm.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

Spec = Sequence[Tuple[str, Tuple[int, ...]]]


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
        return "uniform"
    if leaf in ("bias", "running_mean"):
        return "bias"
    return "normal"


def _fan(name: str, shape: Tuple[int, ...], init_fan: Mapping[str, object]) -> int:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 2:
        return shape[1]
    if leaf in init_fan:
        fan = init_fan[leaf]
        return math.prod(shape[:-1]) if fan == "rows" else int(fan)
    return shape[-2] if len(shape) >= 2 else shape[0]


def make_weights(spec: Spec, seed: int, device, init_fan: Mapping[str, object] = ()) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``spec`` (names and shapes), f32 on ``device``."""
    init_fan = dict(init_fan)
    spec = sorted((name, tuple(shape)) for name, shape in spec)
    normal = [(n, s) for n, s in spec if _kind(n, s) != "uniform"]
    uniform = [(n, s) for n, s in spec if _kind(n, s) == "uniform"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    draws = {
        "normal": torch.randn(sum(math.prod(s) for _, s in normal), generator=gen, device=device),
        "uniform": torch.rand(sum(math.prod(s) for _, s in uniform), generator=gen, device=device) + 0.5,
    }
    out: Dict[str, torch.Tensor] = {}
    offsets = {"normal": 0, "uniform": 0}
    for name, shape in spec:
        kind = _kind(name, shape)
        pool = "uniform" if kind == "uniform" else "normal"
        size = math.prod(shape)
        t = draws[pool][offsets[pool]:offsets[pool] + size].view(shape)
        offsets[pool] += size
        if kind == "bias":
            t = t * 0.1
        elif kind == "normal":
            t = t / math.sqrt(_fan(name, shape, init_fan))
        out[name] = t.clone()
    return out


def state_spec(module: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """Names and shapes of a module's parameters and buffers, sorted."""
    return sorted((n, tuple(t.shape)) for n, t in module.state_dict().items())
