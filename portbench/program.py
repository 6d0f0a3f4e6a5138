"""What a traffic kind takes from the program, and the reference beside it.

The program is ``patchaugnet_tpu_torch``: its model factory, its serving
entry and its train step. The weights are the benchmark's
(:mod:`portbench.weights`), made on the device from the run's seed and
loaded by name; the reference's list of names and shapes must be the
model's, so both sides take the same tensors.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

from .weights import make_weights, state_spec


def model_config(run) -> Dict[str, Any]:
    return dict(run.config["model"])


def reference(run):
    """``reference/<model_type>.py``."""
    return importlib.import_module(f"portbench.reference.{run.config['model']['model_type']}")


def weights(run, spec):
    return make_weights(spec, run.seed, run.device, run.config.get("init_fan", {}))


def build_model(run):
    """The program's model at the configuration, on the run's device, with
    the benchmark's weights."""
    from patchaugnet_tpu_torch.models import get_model

    cfg = model_config(run)
    model = get_model(cfg["model_type"], cfg).to(run.device)
    spec = state_spec(model)
    ref_spec = sorted((n, tuple(s)) for n, s in reference(run).spec(cfg))
    if spec != ref_spec:
        missing = sorted(set(spec) ^ set(ref_spec))[:8]
        raise ValueError(f"the model's parameters and statistics differ from the reference's: {missing}")
    model.load_state_dict(weights(run, spec))
    return model


def reference_weights(run):
    cfg = model_config(run)
    return weights(run, reference(run).spec(cfg))
