"""Helpers of the benchmark's CPU tests: a checkout in a temporary
directory holding a small cell of a configuration at its published
widths, run through the harness on the CPU."""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

BENCH = os.path.join(ROOT, "portbench")

# a cell small enough for the CPU: 256 points, the published widths
SMALL_MODEL = {"NUM_POINTS": 256, "SAMPLING": [64, 16, 4], "KNN": [8, 8, 4], "TRAIN_BATCH_SIZE": 2,
               "TRAIN_NEGATIVES_PER_QUERY": 2, "A2B_MAX_ROWS": 64, "A2B_MAX_PAIRS": 4}
SMALL_PPT = {"NUM_POINTS": 256, "SAMPLING": [64, 32, 16, 4], "KNN": [8, 8, 8, 4]}


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def small_checkout(tmp: str, config: str, traffic: dict, workload: dict, model: dict, cell: str = "small") -> str:
    """A checkout under ``tmp`` with one cell ``cell`` of ``config`` (its
    model keys updated by ``model``), the given traffic mix and workload
    file, and the benchmark's kinds and metric readers."""
    spec = harness.benchmark()
    cfg = harness.load_json(ROOT, "portbench", "configs", f"{config}.json")
    cfg["model"].update(model)
    _write(os.path.join(tmp, "portbench", "configs", f"{config}.json"), cfg)
    _write(os.path.join(tmp, "portbench", "traffic", "small.json"), traffic)
    _write(os.path.join(tmp, "portbench", "workloads", f"{cell}.json"), workload)
    for kind in ("serve", "train"):
        os.symlink(os.path.join(BENCH, "traffic", f"{kind}.py"), os.path.join(tmp, "portbench", "traffic", f"{kind}.py"))
    os.symlink(os.path.join(BENCH, "metrics"), os.path.join(tmp, "portbench", "metrics"))
    spec["configs"] = [dict(c, file=f"portbench/configs/{config}.json") for c in spec["configs"] if c["name"] == config]
    spec["workloads"] = [{"name": cell, "config": config, "traffic": "small", "chips": 1, "why": "test"}]
    like = {"serve": "pan.serve.b100", "train": "pan.train.t72"}[traffic["kind"]]
    for key in ("end_to_end", "per_layer"):
        spec[key] = [dict(m, workloads=[cell]) for m in harness.for_cell(spec[key], like)]
    _write(os.path.join(tmp, "BENCHMARK.json"), spec)
    return tmp


def run_small(root: str, seed: int = 5, seconds: float = 0.0, cell: str = "small"):
    """Run the cell on the CPU through the harness; the :class:`harness.Run` and the result line."""
    run = harness.prepare(cell, seed, seconds, False, time.perf_counter(), device="cpu", root=root)
    return run, harness.execute(run, root=root)


SERVE_TRAFFIC = {"kind": "serve", "batch": 2, "points": 256, "pool": 2, "warmup": 1}
SERVE_WORKLOAD = {"check": {"sample_batches": 2, "reference_block": 2}, "limits": {"desc_gap": 1e-4},
                  "trace_items": 2, "trace_host_items": 1, "model_flops_per_item": 1.0}
TRAIN_TRAFFIC = {"kind": "train", "points": 256, "pool": 3, "a2b_valid_share": 0.5, "checked_steps": 3}
TRAIN_WORKLOAD = {"check": {"grad_floor": 1e-3}, "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 0.1},
                  "trace_items": 2, "trace_host_items": 1, "model_flops_per_item": 1.0}
