"""The control and the planted faults: the timed path broken underneath a
run, for the readings that set each limit (``tools/readings.py``) and for
the tests that see ``correct`` come out false.

Each is a context manager that replaces an entry of the program while it
is open:

- ``control``: the plain reference in the program's place, its products
  in TF32 (the precision below the configuration's f32);
- ``stale``: each answer is the previous call's (serve), or the step
  leaves the parameters as they were (train: ``unchanged``);
- ``half``: half of the batch left out, the rest's mean in its place
  (serve), or the step taken on the first half of the tuples (train);
- ``altered``: one number of one answer altered where it is produced.
"""
from __future__ import annotations

import contextlib
import importlib
from typing import Iterator

import torch

from .reference import tuple_step
from .reference.common import Net

SERVE = ("control", "stale", "half", "altered")
TRAIN = ("control", "unchanged", "half", "altered")
ALTER = 0.01


@contextlib.contextmanager
def _patched(module, name: str, value) -> Iterator[None]:
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _reference_module(cfg):
    return importlib.import_module(f"portbench.reference.{cfg['model_type']}")


def serve_fault(name: str, cfg) -> contextlib.AbstractContextManager:
    from patchaugnet_tpu_torch import serving

    real = serving.build_forward_fn

    def build(model, device="cuda"):
        forward = real(model, device)
        last = []

        def control(clouds):
            ref = _reference_module(cfg)
            net = Net({k: v.detach() for k, v in model.state_dict().items()}, tf32=True)
            with torch.no_grad():
                return ref.forward(net, cfg, clouds)

        def faulty(clouds):
            out = forward(clouds)
            if name == "stale":
                prev = last[0] if last else out
                last[:] = [out]
                return prev
            if name == "half":
                h = out.shape[0] // 2
                out = out.clone()
                out[h:] = out[:h].mean(dim=0)
                return out
            if name == "altered":
                out = out.clone()
                out[len(last) % out.shape[0], 0] += ALTER
                last.append(None)
                return out
            raise ValueError(f"unknown serve fault {name!r}")

        return control if name == "control" else faulty

    return _patched(serving, "build_forward_fn", build)


def train_fault(name: str, cfg) -> contextlib.AbstractContextManager:
    from patchaugnet_tpu_torch import train
    from patchaugnet_tpu_torch.serving import global_desc

    real = train.build_train_step

    def build(model, config):
        if name == "altered":
            def alter(_module, _args, out):
                desc = global_desc(out)
                bump = torch.zeros_like(desc)
                bump[0, 0] = ALTER
                return out._replace(global_desc=desc + bump)

            model.register_forward_hook(alter)
            return real(model, config)
        if name == "half":
            half_cfg = dict(config, TRAIN_BATCH_SIZE=config["TRAIN_BATCH_SIZE"] // 2)
            inner = real(model, half_cfg)

            def half(state, clouds, corr, mask):
                n = clouds.shape[0] // 2
                keep = corr.row_valid & (corr.row_q_cloud < n) & (corr.row_n_cloud < n)
                corr = corr._replace(row_q_cloud=torch.where(keep, corr.row_q_cloud, 0),
                                     row_n_cloud=torch.where(keep, corr.row_n_cloud, 0), row_valid=keep)
                return inner(state, clouds[:n], corr, mask[:n])

            return half
        if name == "unchanged":
            loss_fn = train.make_loss_fn(model, config)

            def unchanged(state, clouds, corr, mask):
                state.model.train()
                with torch.no_grad():
                    _, metrics = loss_fn(clouds, corr.to(clouds.device), mask)
                return state, metrics

            return unchanged
        if name == "control":
            return _control_step(config)
        raise ValueError(f"unknown train fault {name!r}")

    return _patched(train, "build_train_step", build)


def _control_step(cfg):
    """The reference step in TF32 on the model's tensors, written back into
    the model and the optimizer's moments."""
    ref = _reference_module(cfg)
    adam = {"m": {}, "v": {}, "t": 0}

    def step(state, clouds, corr, mask):
        sd = state.model.state_dict()
        adam["params"] = {k: v.detach().clone() for k, v in sd.items()}
        tables = tuple(corr[:6]) + (corr.row_valid.to(torch.int32),)
        batch = tuple_step.Batch(clouds, mask, tables, corr.num_pairs)
        metrics, _ = tuple_step.step(ref.forward, adam, cfg, batch, state.schedule(state.step), tf32=True)
        with torch.no_grad():
            for k, v in adam["params"].items():
                sd[k].copy_(v)
            for k, p in state.model.named_parameters():
                state.optimizer.state[p]["exp_avg"] = adam["m"][k]
        state.step += 1
        return state, {k: torch.tensor(v, device=clouds.device) for k, v in metrics.items()}

    return step


def fault(kind: str, name: str, cfg) -> contextlib.AbstractContextManager:
    return serve_fault(name, cfg) if kind == "serve" else train_fault(name, cfg)

