"""The port's training-quality harness against the JAX package's.

``bench_quality_torch.py`` against ``bench_quality.py``: the families and
the common settings key by key, the hardened scenes bit for bit. The
port's ``train_one_epoch`` against the JAX one for two batches on the
hardened tiny scene (the deterministic probe's), from carried weights
and equal seeds: each batch's queries, clouds and correspondence tables
equal; the first batch's metrics within LOSS_RTOL, the second's within
EPOCH_STEP2_RTOL. That run takes SGD with momentum (the probe's config
otherwise): Adam's first update moves each parameter by the learning rate
times the sign of its gradient, and the SA leaves' signs differ between
the port and JAX as they differ between JAX's own jitted and eager
gradients (``tests/test_torch_train.py``), so with Adam the second
batch's place-recognition term lies 2.2e-2 from JAX's (measured), with SGD
2.2e-3; Adam itself is held to optax in ``tests/test_torch_train.py``.
The JAX step is compiled with XLA's optimisations on: with them off it
returns NaN metrics at the second batch. The harness's
``run`` on the CPU at 128 points. The deterministic probe's config equals
the JAX suite's, and two in-process runs give bit-equal parameters.
Nothing here trains long: the recall gates run on the card
(``chip_smoke.py`` phase 14).
"""
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import data as jdata
from patchaugnet_tpu import train as jtrain
from patchaugnet_tpu.models import get_model as jax_get_model

import bench_quality_torch as bq
from patchaugnet_tpu_torch import train
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.models import get_model
from tests import torch_deterministic_probe as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 5e-5                   # the first batch (tests/test_torch_train.py)
# the second batch, after one SGD update: measured 2.2e-3 (place recognition)
EPOCH_STEP2_RTOL = 1e-2
TINY = dict(NUM_POINTS=128, SAMPLING=[32, 8, 4], KNN=[8, 8, 4], MAX_SAMPLES=[8, 32, 128], A2B_MAX_ROWS=64,
            A2B_MAX_PAIRS=4)
TINY_PPT = dict(NUM_POINTS=128, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4], MAX_SAMPLES=[8, 16, 32, 128])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tensors are small, and a thread pool per
    test process spins against the other pytest workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jbench():
    """``bench_quality`` imported with its import-time backend watchdog
    stubbed (it probes the TPU), and the matmul precision it sets put back."""
    precision = jax.config.jax_default_matmul_precision
    saved = sys.modules.get("bench_models")
    sys.modules["bench_models"] = types.SimpleNamespace(_backend_watchdog=lambda: None)
    try:
        import bench_quality
    finally:
        if saved is None:
            del sys.modules["bench_models"]
        else:
            sys.modules["bench_models"] = saved
        jax.config.update("jax_default_matmul_precision", precision)
    return bench_quality


def test_families_and_common_match_bench_quality(jbench):
    """The same families, each config key by key, scene noise and patch
    centres; ``init_kwargs`` ({"with_patches": True} for the flagship) has
    no counterpart: a port module holds every parameter from construction."""
    assert bq.COMMON == jbench.COMMON
    assert sorted(bq.FAMILIES) == sorted(jbench.FAMILIES)
    for name, fam in jbench.FAMILIES.items():
        mine = bq.FAMILIES[name]
        assert set(mine) == set(fam) - {"init_kwargs"}, name
        assert mine["cfg"] == fam["cfg"], name
        assert (mine["with_center"], mine["scale"]) == (fam["with_center"], fam["scale"]), name
    assert (bq.EPOCHS, bq.STEPS_PER_EPOCH, bq.EVAL_TOP_K, bq.EVAL_BATCH) == (12, 24, 5, 12)


@pytest.mark.parametrize("for_training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("family", ["patch_aug_net", "pptnet"])
def test_hardened_scene_matches_bench_quality(jbench, family, for_training):
    """The hardened split's clouds bit-equal to ``bench_quality.make_ds``'s
    (2 trips x 24 submaps of 4096 points, noise 0.35, PPT-Net's 0.9)."""
    cfg, fam = jbench.FAMILIES[family]["cfg"], jbench.FAMILIES[family]
    want = jbench.make_ds(cfg, for_training, fam["scale"]).scene
    got = bq.make_ds(cfg, for_training, bq.FAMILIES[family]["scale"], "cpu").scene
    assert got._clouds.shape == (48, 4096, 3)
    np.testing.assert_array_equal(got._clouds, want._clouds)
    assert len(got.records) == len(want.records)


def _jax_ds(for_training):
    cfg = probe.SMALL_CFG
    pr = jdata.PlaceRecognitionDataset(
        "synthetic", for_training, num_pos=cfg["TRAIN_POSITIVES_PER_QUERY"],
        num_neg=cfg["TRAIN_NEGATIVES_PER_QUERY"], load_overlap_indices=True, num_points=cfg["NUM_POINTS"])
    pr.scene.create_synthetic(n_trips=probe.N_TRIPS, n_per_trip=probe.N_PER_TRIP, num_points=cfg["NUM_POINTS"])
    r = np.random.RandomState(probe.NOISE_SEED)
    pr.scene._clouds = pr.scene._clouds + r.randn(*pr.scene._clouds.shape).astype(np.float32) * probe.NOISE_SCALE
    pr.scene._pc_cache.clear()
    pr.scene._pc_order.clear()
    return pr


def _recording(ds, batches):
    """Record each batch ``ds.iter_epoch`` yields."""
    iter_epoch = ds.iter_epoch

    def wrapped(*args, **kwargs):
        for batch in iter_epoch(*args, **kwargs):
            batches.append(batch)
            yield batch

    ds.iter_epoch = wrapped


def _stepping(step, calls):
    """Record each step call's tables, mask and metrics."""
    def wrapped(state, clouds, corr, mask):
        state, metrics = step(state, clouds, corr, mask)
        calls.append((corr, mask, metrics))
        return state, metrics

    return wrapped


def test_train_one_epoch_matches_jax():
    """Two batches of ``train_one_epoch`` from carried weights: the same
    queries, clouds, tables and cloud masks; metrics per batch (SGD with
    momentum: see the module's docstring)."""
    cfg = dict(probe.SMALL_CFG, OPTIMIZER="momentum")
    jds, pds = _jax_ds(True), probe.make_ds(True, "cpu")
    np.testing.assert_array_equal(pds.scene._clouds, jds.scene._clouds)
    model = jax_get_model("patch_aug_net", cfg)
    tuple_size = 1 + cfg["TRAIN_POSITIVES_PER_QUERY"] + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 1
    x = jnp.zeros((cfg["TRAIN_BATCH_SIZE"] * tuple_size, cfg["NUM_POINTS"], 3))
    jstate = jtrain.create_train_state(model, jax.random.PRNGKey(0), x, cfg, init_kwargs={"with_patches": True})
    variables = jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    pstate = train.create_train_state(load_jax_variables(get_model("patch_aug_net", cfg), variables), cfg,
                                      device="cpu")

    jbatches, pbatches, jcalls, pcalls = [], [], [], []
    _recording(jds, jbatches)
    _recording(pds, pbatches)
    random.seed(0)
    np.random.seed(0)
    jtrain.train_one_epoch(jstate, _stepping(jtrain.build_train_step(model, cfg), jcalls), jds, cfg, 0,
                           center_fn=jtrain.build_center_fn(cfg["SAMPLING"][0]), max_batches=2)
    train.train_one_epoch(pstate, _stepping(train.build_train_step(pstate.model, cfg), pcalls), pds, cfg, 0,
                          random.Random(0), np.random.RandomState(0),
                          center_fn=train.build_center_fn(cfg["SAMPLING"][0], "cpu"), max_batches=2)
    assert len(jcalls) == len(pcalls) == 2
    for i, (jb, pb, (jcorr, jmask, jm), (pcorr, pmask, pm)) in enumerate(zip(jbatches, pbatches, jcalls, pcalls)):
        assert jb.query_indices == pb.query_indices, i
        np.testing.assert_array_equal(jb.clouds, pb.clouds)
        assert list(jb.nn_dict) == list(pb.nn_dict) and pb.nn_dict, i
        for name in jcorr._fields[:7]:
            np.testing.assert_array_equal(np.asarray(getattr(jcorr, name)), getattr(pcorr, name).numpy(),
                                          err_msg=f"batch {i} {name}")
        np.testing.assert_array_equal(np.asarray(jmask), pmask.numpy())
        assert set(jm) == set(pm)
        for key in jm:
            np.testing.assert_allclose(pm[key].item(), float(jm[key]), rtol=LOSS_RTOL if i == 0 else EPOCH_STEP2_RTOL,
                                       atol=1e-7, err_msg=f"batch {i} {key}")


@pytest.mark.parametrize("family,overrides", [("patch_aug_net", TINY), ("pptnet", TINY_PPT),
                                              ("pointnet_vlad", {"NUM_POINTS": 128})],
                         ids=["patch_aug_net", "pptnet", "pointnet_vlad"])
def test_run_on_the_cpu(family, overrides):
    """``run`` at 128 points for 1 epoch of 2 batches: finite recall before
    and after, finite totals, the run's JSON line."""
    lines = []
    result = bq.run(family, device="cpu", epochs=1, max_batches=2, overrides=overrides, log=lines.append)
    assert 0.0 <= result["recall_at_1_init"] <= 100.0 and 0.0 <= result["recall_at_1_trained"] <= 100.0
    assert result["steps"] == 2 and np.isfinite(result["epoch_totals"]).all()
    assert result["patch_batches"] == (2 if family == "patch_aug_net" else 0)
    assert result["eval_batches"] == 2 * -(-48 // bq.EVAL_BATCH)
    assert lines[0].startswith(f"{family}: init recall@1") and "TRAINED" in lines[-1] and len(lines) == 3
    assert all(torch.isfinite(p).all() for p in result["state"].model.parameters())
    line = bq.record_line(result)
    assert '"family"' in line and '"state"' not in line


def test_bf16_run_on_the_cpu():
    result = bq.run("patch_aug_net", "bfloat16", device="cpu", epochs=1, max_batches=1, overrides=TINY,
                    log=lambda s: None)
    assert result["precision"] == "bfloat16" and np.isfinite(result["epoch_totals"]).all()
    assert all(p.dtype == torch.float32 for p in result["state"].model.parameters())


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_smoothap_quality_run_on_the_cpu(backend):
    """``chip_smoke.py`` phase 14's MinkLoc3Dv2 SmoothAP run, 2 steps: the
    JAX gates' configs (``tests/test_minkloc.py`` PARAM, dense at grid 16;
    ``tests/test_minkloc_sparse.py`` SPARSE_PARAM at step 0.1), finite
    losses, recall in range."""
    import chip_smoke
    from tests.test_minkloc import PARAM
    from tests.test_minkloc_sparse import SPARSE_PARAM

    want = {"dense": PARAM, "sparse": dict(SPARSE_PARAM, quantization_step=0.1)}[backend]
    assert chip_smoke.MINK_QUALITY_PARAMS[backend] == want
    r0, r1, losses, ms = chip_smoke.smoothap_quality(torch, torch.device("cpu"), backend, steps=2)
    assert 0.0 <= r0 <= 100.0 and 0.0 <= r1 <= 100.0 and len(losses) == 2 and np.isfinite(losses).all()


def test_probe_config_matches_the_jax_suite():
    from tests.test_train import SMALL_CFG

    assert probe.SMALL_CFG == SMALL_CFG


def test_probe_is_bit_reproducible():
    """Two in-process runs of 2 epochs x 2 batches: the same parameters and
    the same recall, f32 and bf16."""
    a = probe.probe("cpu", epochs=2, max_batches=2)
    b = probe.probe("cpu", epochs=2, max_batches=2)
    assert a[:3] == b[:3]
    assert all(torch.equal(p, q) for p, q in zip(a[3].parameters(), b[3].parameters()))
    assert probe.probe_line(*a[:3]).startswith("DETPROBE recall=")


_IMPORT_THE_HARNESS = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "patchaugnet_tpu", "__graft_entry__", "bench_models",
             "bench_quality"):
    sys.modules[name] = None
import bench_quality_torch, chip_smoke
sys.path.insert(0, "tests")
import torch_deterministic_probe
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "patchaugnet_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print("ok")
"""


def test_harness_and_probe_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_THE_HARNESS], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
