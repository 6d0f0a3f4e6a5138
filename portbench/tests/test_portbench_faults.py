"""The run with its timed path broken underneath comes out not correct:
the control (the reference in TF32 in the program's place) and each
fault a cell can have, against the cells' own limits; a sound run comes
out correct. On the CPU, at 256 points and the published widths, the
harness's look for a card skipped."""
import time

import pytest

import benchutil
from portbench import faults, harness, program


def _limits(cell):
    return harness.load_json(benchutil.BENCH, "workloads", f"{cell}.json")["limits"]


def _run(tmp_path, config, model, traffic, workload, variant, seconds):
    root = benchutil.small_checkout(str(tmp_path), config, traffic, workload, model)
    run = harness.prepare("small", 2**31 + 77, seconds, False, time.perf_counter(), device="cpu", root=root)
    if variant == "sound":
        return harness.execute(run, root=root)
    with faults.fault(traffic["kind"], variant, program.model_config(run)):
        return harness.execute(run, root=root)


SERVE = [("patch_aug_net", benchutil.SMALL_MODEL, "pan.serve.b100"), ("pptnet_origin", benchutil.SMALL_PPT,
                                                                        "ppt.serve.b100")]


@pytest.mark.parametrize("variant", ("sound",) + faults.SERVE)
@pytest.mark.parametrize("config,model,cell", SERVE, ids=["patch_aug_net", "pptnet"])
def test_serve_variant(tmp_path, config, model, cell, variant):
    workload = dict(benchutil.SERVE_WORKLOAD, limits=_limits(cell))
    result = _run(tmp_path, config, model, benchutil.SERVE_TRAFFIC, workload, variant, 0.3)
    assert result["correct"] is (variant == "sound"), result["checks"]


@pytest.mark.parametrize("variant", ("sound",) + faults.TRAIN)
def test_train_variant(tmp_path, variant):
    workload = dict(benchutil.TRAIN_WORKLOAD, limits=_limits("pan.train.t72"))
    result = _run(tmp_path, "patch_aug_net", benchutil.SMALL_MODEL, benchutil.TRAIN_TRAFFIC, workload, variant, 0.0)
    assert result["correct"] is (variant == "sound"), result["checks"]
