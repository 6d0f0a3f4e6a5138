"""The harness finds a cell, its configuration, traffic kind and metrics
by name from files; a run with no card fails without a result."""
import json
import os
import shutil
import subprocess
import sys
import time

import benchutil
from portbench import harness

DUMMY_KIND = '''
def run(r):
    r.values["setup_s"] = 0.5
    r.values["widgets_per_s"] = r.traffic["rate"] * r.config["model"]["scale"]
    r.record["things"] = [1.0, 3.0]
    r.attempted = 4
    r.checks["gap"] = (0.0, r.workload["limits"]["gap"])
'''
DUMMY_METRIC = '''
def read(run):
    return sum(run.record["things"]) / len(run.record["things"])
'''


def _dummy_checkout(root):
    os.makedirs(os.path.join(root, "portbench", "configs"))
    for sub in ("traffic", "workloads", "metrics"):
        os.makedirs(os.path.join(root, "portbench", sub))
    files = {
        "BENCHMARK.json": {"command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 1,
                           "configs": [{"name": "toy", "source": "https://example.org", "reduced": [], "why": "t",
                                        "file": "portbench/configs/toy.json"}],
                           "workloads": [{"name": "toy.w", "config": "toy", "traffic": "steady", "chips": 1,
                                          "why": "t"}],
                           "end_to_end": [{"name": "widgets_per_s", "unit": "1/s", "better": "higher", "bound": 0.1,
                                           "source": "host_clock"},
                                          {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                                           "source": "host_clock"}],
                           "per_layer": [{"name": "things_mean", "unit": "1", "better": "lower", "layer": "toy",
                                          "source": "program_counter", "moves": "widgets_per_s"}]},
        "portbench/configs/toy.json": {"model": {"scale": 3}},
        "portbench/traffic/steady.json": {"kind": "dummy", "rate": 7},
        "portbench/workloads/toy.w.json": {"limits": {"gap": 0.1}},
    }
    for path, obj in files.items():
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(root, "portbench", "traffic", "dummy.py"), "w") as f:
        f.write(DUMMY_KIND)
    with open(os.path.join(root, "portbench", "metrics", "things_mean.py"), "w") as f:
        f.write(DUMMY_METRIC)


def test_dummy_cell_found_by_name(tmp_path):
    root = str(tmp_path)
    _dummy_checkout(root)
    for trace, want in ((False, {"widgets_per_s": 21, "setup_s": 0.5}), (True, {"things_mean": 2.0})):
        run = harness.prepare("toy.w", 1, 1.0, trace, time.perf_counter(), device="cpu", root=root)
        result = harness.execute(run, root=root)
        assert {k: m["value"] for k, m in result["metrics"].items()} == want
        assert result["correct"] is True and result["attempted"] == 4 and result["failed"] == 0
        assert list(result)[-1] == "checks" and result["checks"] == {"gap": {"value": 0.0, "limit": 0.1}}
        assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_each_cell_has_its_files():
    spec = harness.benchmark()
    for cell in spec["workloads"]:
        run = harness.prepare(cell["name"], 0, 1.0, False, 0.0, device="cpu")
        assert os.path.exists(os.path.join(benchutil.BENCH, "traffic", f"{run.traffic['kind']}.py"))
        assert set(run.workload["limits"]) and run.workload["model_flops_per_item"] > 0
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(benchutil.BENCH, "metrics", f"{m['name']}.py"))
        assert all(w in {c["name"] for c in spec["workloads"]} for w in m.get("workloads", []))


def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "pan.serve.b100", "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_no_card_no_result():
    """Here, without a card, the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present: the run would measure")
    proc = _run_py(benchutil.ROOT)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "GPU" in proc.stderr


def test_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ gives no result."""
    root = str(tmp_path)
    shutil.copy(os.path.join(benchutil.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(benchutil.BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = _run_py(root)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_host_clock_readers():
    """The per-layer host readers: nothing recorded reads None; a batch p95 is numpy's over the record."""
    import numpy as np

    run = harness.Run({}, {}, {}, {}, 0, 1.0, True, "cpu", 0.0)
    readers = {name: harness.load_module(os.path.join(benchutil.BENCH, "metrics", f"{name}.py"), "m")
               for name in ("batch_ms_p95.serve", "enqueue_ms.serve")}
    assert all(r.read(run) is None for r in readers.values())
    batch_s = [0.030 + 0.001 * (k % 7) for k in range(200)] + [0.050] * 4
    run.record.update(batch_s=batch_s, enqueue_s=[0.010, 0.020])
    assert readers["batch_ms_p95.serve"].read(run) == float(np.percentile(np.array(batch_s) * 1e3, 95))
    assert abs(readers["enqueue_ms.serve"].read(run) - 15.0) < 1e-9
