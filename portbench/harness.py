"""One run of one cell: find its files by name, run its traffic kind, read
its metrics, check its outputs, print the result.

Everything that belongs to one configuration, cell, traffic mix or
per-layer metric is a file of its own under ``portbench/``, found by the
names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  model's keys, its dtype and peak;
- ``traffic/<traffic>.json``: the mix's parameters, with the ``kind``
  whose driver ``traffic/<kind>.py`` runs it;
- ``workloads/<cell>.json``: the cell's check (sample sizes, the limit of
  each number compared), its traced slice and its model FLOPs per item;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``;
- ``reference/<model_type>.py``: the plain reference.

A traffic kind's ``run(run)`` builds the program, warms it, measures the
window and checks the outputs, and fills the :class:`Run` it is given.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "patchaugnet_tpu")
CACHE = os.path.join(ROOT, "build", "portbench")


class NoDevice(RuntimeError):
    """The card the cell asks for is not there."""


@dataclass
class Run:
    """One run of one cell: its inputs, and what its traffic kind measured."""

    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    workload: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    start: float                       # perf_counter at process start
    values: Dict[str, float] = field(default_factory=dict)     # end-to-end metrics by name
    record: Dict[str, Any] = field(default_factory=dict)       # what per-layer readers read
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)   # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    card_trace: Any = None             # tracing.Trace of the card-only profiled slice
    host_trace: Any = None             # tracing.Trace of the slice profiled with the host

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim for v, lim in self.checks.values())

    def since_start(self) -> float:
        return time.perf_counter() - self.start


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A file of the benchmark as a module (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(root, "BENCHMARK.json")


def for_cell(entries: List[Dict[str, Any]], cell: str) -> List[Dict[str, Any]]:
    """The metrics that a cell reports: those that list it, and those that list none."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's nvcc libraries are in ``build/patchaugnet_tpu_torch`` already)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ.setdefault("USE_FLAX", "0")


def cuda_device(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark runs on an NVIDIA GPU only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} GPUs, {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def prepare(cell_name: str, seed: int, seconds: float, trace: bool, start: float, device=None,
            root: str = ROOT) -> Run:
    """The :class:`Run` of a cell, on its card (``device`` set: on that
    device, without looking for a card)."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[cell_name]
    config_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(root, config_entry["file"])
    traffic = load_json(root, "portbench", "traffic", f"{cell['traffic']}.json")
    workload = load_json(root, "portbench", "workloads", f"{cell_name}.json")
    if device is None:
        device = cuda_device(cell["chips"])
    else:
        import torch

        device = torch.device(device)
    return Run(cell, config, traffic, workload, seed, seconds, trace, device, start)


def execute(run: Run, root: str = ROOT) -> Dict[str, Any]:
    """Run the cell's traffic kind, read the metrics, and build the result line."""
    bench = os.path.join(root, "portbench")
    kind = load_module(os.path.join(bench, "traffic", f"{run.traffic['kind']}.py"), f"portbench_kind_{run.traffic['kind']}")
    kind.run(run)
    spec = benchmark(root)
    name = run.cell["name"]
    metrics: Dict[str, Dict[str, Any]] = {}
    if not run.trace:
        for m in for_cell(spec["end_to_end"], name):
            metrics[m["name"]] = {"value": run.values[m["name"]], "unit": m["unit"]}
    else:
        for m in for_cell(spec["per_layer"], name):
            reader = load_module(os.path.join(bench, "metrics", f"{m['name']}.py"), "portbench_metric")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = _device_line(run)
    result: Dict[str, Any] = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
                              "metrics": metrics, "device": device}
    if run.card_trace is not None and run.host_trace is not None:
        result["breakdown"] = {"device_ops": run.card_trace.device_ops(), "idle_gaps": run.host_trace.idle_gaps()}
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    return result


def _device_line(run: Run) -> Dict[str, Any]:
    import torch

    on_card = getattr(run.device, "type", "cpu") == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
              "count": run.cell["chips"] if on_card else 0,
              "memory_peak_bytes": run.memory_peak_bytes}
    if run.card_trace is not None:
        device["busy_s"] = run.card_trace.busy_s
        device["window_s"] = run.card_trace.window_s
    return device


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def print_result(result: Dict[str, Any]) -> None:
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
