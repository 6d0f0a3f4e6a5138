"""The port's epoch loop and CLIs, on the CPU.

- ``prepare_patch_inputs`` with the JAX centres and with the port's
  (``train.build_center_fn`` on the CPU): tables and mask equal;
- ``train.evaluate`` on the tiny configuration, with the JAX model's
  weights carried over by ``compat.load_jax_variables``: descriptors
  within 1e-4, recall and 1% recall equal to the JAX package's
  ``train.evaluate``;
- a smoke of ``train_torch.py`` (an epoch of two batches, then ``--resume``)
  and ``evaluate_torch.py`` on the tiny configuration, in subprocesses
  where pandas, sklearn, PyYAML, protobuf, TensorBoard, JAX and the JAX
  package do not import, as on the card's machine;
- what the CLIs refuse: no CUDA device without ``--platform cpu``, and each
  option that is not ported;
- the deployment tools on the tiny configuration, in this process:
  ``evaluate_torch.py --weight`` on a reference ``.pth`` (the eval's
  descriptors those of the model that wrote it), ``parity_harness_torch.py``
  diffed against its own first run (zero delta, PASS), and
  ``train_torch.py --print-flops``.
"""
import glob
import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchaugnet_tpu import data as jdata
from patchaugnet_tpu import train as jtrain
from patchaugnet_tpu.models import PatchAugNet as JaxPatchAugNet

from patchaugnet_tpu_torch import configs, data, serving, train
from patchaugnet_tpu_torch.compat import load_jax_variables, save_reference_checkpoint
from patchaugnet_tpu_torch.models import PatchAugNet, get_model
from patchaugnet_tpu_torch.nn import training_init_

import evaluate_torch
import parity_harness_torch
import train_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = configs.TINY_SMOKE
CPU = "cpu"
# runs a script as on the card's machine: these packages do not import
_BLOCKED_RUN = """
import runpy, sys
for name in ("pandas", "sklearn", "yaml", "google.protobuf", "tensorboard", "jax", "jaxlib", "flax",
             "patchaugnet_tpu"):
    sys.modules[name] = None
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", _BLOCKED_RUN, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("epoch", [0, 11], ids=["warm-up", "hard-negative-patches"])
def test_prepare_patch_inputs_matches_jax(epoch):
    """The tables of one synthetic batch at the tiny configuration, the
    centres from each side's ``build_center_fn``; after epoch 10 the
    negatives come from the bad-far lists."""
    cfg = dict(TINY)
    kw = dict(num_pos=cfg["TRAIN_POSITIVES_PER_QUERY"], num_neg=cfg["TRAIN_NEGATIVES_PER_QUERY"],
              load_overlap_indices=True, num_points=cfg["NUM_POINTS"], seed=3)
    jbatch = next(jdata.PlaceRecognitionDataset("synthetic", True, **kw).iter_epoch(2))
    pbatch = next(data.PlaceRecognitionDataset("synthetic", True, device=CPU, **kw).iter_epoch(2))
    np.testing.assert_array_equal(jbatch.clouds, pbatch.clouds)
    random.seed(9)
    np.random.seed(9)
    jcorr, jmask = jtrain.prepare_patch_inputs(jbatch, jtrain.build_center_fn(cfg["SAMPLING"][0]), cfg, epoch)
    pcorr, pmask = train.prepare_patch_inputs(pbatch, train.build_center_fn(cfg["SAMPLING"][0], device=CPU), cfg,
                                              epoch, random.Random(9), np.random.RandomState(9))
    for name in jcorr._fields[:7]:
        np.testing.assert_array_equal(np.asarray(getattr(jcorr, name)), getattr(pcorr, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jmask), pmask.numpy())
    assert int(pcorr.row_valid.sum()) > 0 and int(pmask.sum()) == 6


def _random_batch_stats(tree, rng):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _random_batch_stats(val, rng)
        elif key == "var":
            out[key] = (rng.rand(*val.shape) + 0.5).astype(np.float32)
        else:
            out[key] = (rng.randn(*val.shape) * 0.2).astype(np.float32)
    return out


def test_evaluate_matches_jax():
    """The eval of the synthetic test split (48 records in two trips) on
    the same weights: descriptors within 1e-4, recall@1..25, precision@1
    and 1% recall averaged over the trip pairs equal."""
    kw = dict(num_pos=TINY["EVAL_POSITIVES_PER_QUERY"], num_neg=TINY["EVAL_NEGATIVES_PER_QUERY"],
              num_points=TINY["NUM_POINTS"])
    jds = jdata.PlaceRecognitionDataset("synthetic", False, **kw)
    pds = data.PlaceRecognitionDataset("synthetic", False, device=CPU, **kw)
    jm = JaxPatchAugNet(param=TINY, use_a2a_recon=False)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                         jnp.zeros((2, TINY["NUM_POINTS"], 3))))
    variables = {"params": variables["params"],
                 "batch_stats": _random_batch_stats(variables["batch_stats"], np.random.RandomState(1))}
    want = jtrain.evaluate(variables, jtrain.build_forward_fn(jm, TINY), jds, top_k=25, batch_size=36)
    model = load_jax_variables(PatchAugNet(TINY), variables)
    got = train.evaluate(serving.build_forward_fn(model, device=CPU), pds, top_k=25, batch_size=36)
    np.testing.assert_allclose(jds.scene.global_descs, pds.scene.global_descs, atol=1e-4)
    assert got["num_pairs"] == want["num_pairs"] == 2
    np.testing.assert_array_equal(got["ave_recall"], want["ave_recall"])
    # precision past rank 1 counts every positive in the top 25, whose order
    # among near-equal descriptors (the synthetic places' pairs) follows
    # differences of 1e-7; recall, the eval's metric, takes only the first
    assert got["ave_precision"][0] == want["ave_precision"][0]
    assert got["ave_one_percent_recall"] == want["ave_one_percent_recall"]
    assert got["recall_at_1"] == want["recall_at_1"] and got["lost_sum"] == want["lost_sum"]
    assert got["desc_time"]["mean_ms"] >= 0


def test_cli_smoke_train_resume_evaluate(tmp_path):
    """train_torch.py for an epoch of two batches, ``--resume`` from its
    checkpoint for two epochs (the JAX CLI resumes at the saved epoch),
    then evaluate_torch.py on the last checkpoint; every logged loss
    finite, the optimizer's count carried through the resume."""
    exp = str(tmp_path / "exp")
    common = ["--config", "configs/tiny_smoke.yaml", "--dataset", "synthetic", "--platform", "cpu",
              "--max-batches", "2", "--exp_dir", exp]
    proc = _run("train_torch.py", *common, "--epochs", "1")
    assert proc.returncode == 0, proc.stderr[-4000:]
    saved = os.path.join(exp, "patch_aug_net", "saved_model")
    first = os.path.join(saved, "train_epoch_0_end")
    assert torch.load(first)["step"] == 2
    proc = _run("train_torch.py", *common, "--epochs", "2", "--resume", first)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Resumed from" in proc.stderr
    last = torch.load(os.path.join(saved, "train_epoch_1_end"))
    assert last["step"] == 6 and last["epoch"] == 1
    losses = []
    for path in glob.glob(os.path.join(exp, "patch_aug_net", "events", "*", "metrics.jsonl")):
        with open(path) as f:
            losses += [json.loads(line) for line in f if '"iter_loss"' in line]
    assert len(losses) == 6 and all(np.isfinite(r["train_total"]) for r in losses)

    proc = _run("evaluate_torch.py", "--config", "configs/tiny_smoke.yaml", "--dataset", "synthetic",
                "--platform", "cpu", "--weight", os.path.join(saved, "train_epoch_1_end"), "--exp_dir", exp)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Average Recall @1:" in proc.stderr and "loaded weights" in proc.stderr
    assert os.path.exists(os.path.join(exp, "top_k_feat_patch_aug_net_synthetic.pickle"))


def test_train_cli_needs_cuda_or_platform_cpu(tmp_path):
    """Without a card and without ``--platform cpu`` the CLI exits non-zero
    with a message, before it builds anything; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform works")
    proc = _run("train_torch.py", "--config", "configs/tiny_smoke.yaml", "--dataset", "synthetic",
                "--exp_dir", str(tmp_path / "exp"))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--platform cpu" in proc.stderr
    assert not os.path.exists(tmp_path / "exp")
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate_torch.main(["--dataset", "synthetic"])


@pytest.mark.parametrize("flags, item", [
    (["--devices", "2"], "A11"),
])
def test_train_cli_refuses_what_is_not_ported(tmp_path, flags, item):
    """TruncatedSmoothAP (MinkLoc3Dv2) trains on one device: ``--devices``
    above 1 is refused with a message, before any rank starts (ROADMAP C;
    data-parallel training, A11, takes the tuple losses)."""
    argv = ["--config", os.path.join(REPO, "configs", "minkloc3dv2.yaml"), "--dataset", "synthetic", "--platform",
            "cpu", "--exp_dir", str(tmp_path / "exp"), *flags]
    with pytest.raises(ValueError, match=item):
        train_torch.main(argv)


def test_evaluate_cli_refuses_what_is_not_ported(tmp_path):
    """An orbax directory is refused; so is a batch that does not split
    over ``--devices``."""
    base = ["--dataset", "synthetic", "--platform", "cpu", "--exp_dir", str(tmp_path)]
    for flags, error, item in ((["--weight", str(tmp_path)], NotImplementedError, "orbax"),
                               (["--devices", "3"], ValueError, "split evenly")):
        with pytest.raises(error, match=item):
            evaluate_torch.main(base + flags)


def test_config_without_yaml(monkeypatch):
    """Without PyYAML a known file name resolves to the port's copy; any
    other file raises and names the known ones."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = configs.load_config(os.path.join(REPO, "configs", "tiny_smoke.yaml"))
    assert cfg == configs.TINY_SMOKE and cfg is not configs.TINY_SMOKE
    assert configs.load_config(os.path.join(REPO, "configs", "pptnet_origin.yaml")) == configs.PPTNET_ORIGIN
    assert configs.load_config(os.path.join(REPO, "configs", "pointnet_vlad.yaml")) == configs.POINTNET_VLAD
    assert configs.load_config(os.path.join(REPO, "configs", "minkloc3dv2.yaml")) == configs.MINKLOC3DV2
    with pytest.raises(ImportError, match="tiny_smoke.yaml"):
        configs.load_config(os.path.join(REPO, "configs", "unknown.yaml"))


# tiny configurations of the two other dense families, on the synthetic
# scene's 128-point clouds (the PPT-Net one also sets the patch flags,
# which only PatchAugNet reads)
_TINY_FAMILIES = {
    "pptnet": dict(configs.PPTNET_ORIGIN, NUM_POINTS=128, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4],
                   FEATURE_SIZE=[32] * 4, OUTPUT_DIM=[32] * 4, CLUSTER_SIZE=[1, 2, 4, 8],
                   MAX_SAMPLES=[8, 16, 32, 128], use_patch_recon=True, use_patch_feature_contrast=True),
    "pointnet_vlad": dict(configs.POINTNET_VLAD, NUM_POINTS=128, TRAIN_BATCH_SIZE=1),
}


@pytest.mark.parametrize("family", sorted(_TINY_FAMILIES))
def test_cli_trains_and_evaluates_each_family(tmp_path, monkeypatch, family):
    """train_torch.py for one batch of a tiny PPT-Net or PointNetVLAD on
    the synthetic scene, then evaluate_torch.py on its checkpoint, in this
    process (TensorBoard blocked: its import alone takes seconds). The
    train CLI builds no overlap tables for a model without a patch branch,
    whatever the config's patch flags say (``train.py:124-126``); the eval
    reports recall; its forward choice takes the local forward of PPT-Net
    and falls back to the global one for PointNetVLAD
    (``evaluate.py:166-170``)."""
    import yaml

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = dict(_TINY_FAMILIES[family], TRAIN_POSITIVES_PER_QUERY=2, TRAIN_NEGATIVES_PER_QUERY=4)
    path, exp = str(tmp_path / f"{family}.yaml"), str(tmp_path / "exp")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    run = train_torch.main(["--config", path, "--dataset", "synthetic", "--platform", CPU, "--epochs", "1",
                            "--max-batches", "1", "--exp_dir", exp])
    summary = run["summaries"][0]
    assert summary["batches"] == 1 and summary["patch_batches"] == 0
    assert np.isfinite(summary["total"]) and summary["total"] >= 0
    ckpt = os.path.join(exp, family, "saved_model", "train_epoch_0_end")
    out = evaluate_torch.main(["--model_type", family, "--config", path, "--weight", ckpt, "--dataset",
                               "synthetic", "--platform", CPU, "--exp_dir", exp, "--no_save_top_k"])
    assert out["num_pairs"] == 2 and 0 <= out["recall_at_1"] <= 100
    assert out["test_ds"].scene.global_descs.shape == (len(out["test_ds"]), 256 if family == "pointnet_vlad" else 32)
    clouds = out["test_ds"].scene.get_clouds([0, 1])[0]
    got = evaluate_torch.eval_forward(run["state"].model, CPU, local=True)(clouds)
    assert isinstance(got, tuple) == (family == "pptnet")


# a tiny MinkLoc3Dv2 on the synthetic scene's 128-point clouds (its
# config's SmoothAP trainer, a batch of 8 clouds)
_TINY_MINKLOC = dict(configs.MINKLOC3DV2, NUM_POINTS=128, planes=[16, 32, 16, 8], feature_size=32, output_dim=32,
                     quantization_step=0.05, SMOOTHAP_BATCH_SIZE=8)


@pytest.mark.parametrize("cli", ["train", "evaluate"])
def test_cli_minkloc3dv2(tmp_path, monkeypatch, cli):
    """``train``: train_torch.py on the minkloc3dv2 config for an epoch of
    two SmoothAP batches (AdamW, the per-epoch checkpoint and eval);
    ``evaluate``: evaluate_torch.py on a checkpoint of that trainer's
    state, its eval taking the global forward (MinkLoc has no local one),
    its descriptors those of the model's own forward. In this process,
    TensorBoard blocked."""
    import yaml

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path, exp = str(tmp_path / "minkloc3dv2.yaml"), str(tmp_path / "exp")
    with open(path, "w") as f:
        yaml.safe_dump(_TINY_MINKLOC, f)
    saved = os.path.join(exp, "minkloc3dv2", "saved_model")
    if cli == "train":
        run = train_torch.main(["--config", path, "--dataset", "synthetic", "--platform", CPU, "--epochs", "1",
                                "--max-batches", "2", "--exp_dir", exp])
        state, summary = run["state"], run["summaries"][0]
        assert state.step == 2 and isinstance(state.optimizer, torch.optim.AdamW)
        assert state.optimizer.param_groups[0]["weight_decay"] == _TINY_MINKLOC["WEIGHT_DECAY"]
        assert set(summary) == {"loss", "ap"} and 0 <= summary["loss"] <= 1
        assert abs(summary["loss"] + summary["ap"] - 1) < 1e-6
        assert torch.load(os.path.join(saved, "train_epoch_0_end"))["step"] == 2
        assert run["test_ds"].scene.global_descs.shape == (len(run["test_ds"]), 32)   # the epoch's eval ran
        return
    model = training_init_(get_model("minkloc3dv2", _TINY_MINKLOC), torch.Generator().manual_seed(4))
    _, tx = train.build_smoothap_train_step(model, train.multistep_schedule(1e-3, [250], 1), weight_decay=1e-4)
    train.save_checkpoint(tmp_path, train.create_train_state(model, _TINY_MINKLOC, device=CPU, tx=tx), 0)
    out = evaluate_torch.main(["--model_type", "minkloc3dv2", "--config", path, "--weight",
                               str(tmp_path / "train_epoch_0_end"), "--dataset", "synthetic", "--platform", CPU,
                               "--exp_dir", exp, "--no_save_top_k"])
    assert out["num_pairs"] == 2 and 0 <= out["recall_at_1"] <= 100
    test_ds = out["test_ds"]
    clouds = test_ds.scene.get_clouds([0, 1])[0]
    got = evaluate_torch.eval_forward(model, CPU, local=True)(clouds)
    assert isinstance(got, torch.Tensor) and got.shape == (2, 32)
    np.testing.assert_allclose(test_ds.scene.global_descs[:2], got.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference ``.pth`` of the tiny configuration's PatchAugNet (seeded
    initialisation, decoder included), and that model."""
    model = training_init_(get_model("patch_aug_net", TINY), torch.Generator().manual_seed(5))
    path = str(tmp_path_factory.mktemp("pth") / "ref_train_epoch_0_end.pth")
    save_reference_checkpoint(path, "patch_aug_net", model, TINY)
    return path, model


def test_evaluate_cli_reads_a_reference_pth(tmp_path, monkeypatch, reference_pth):
    """``evaluate_torch.py --weight *.pth`` evaluates the weights of the
    model that wrote the file (its descriptors, within the f32 rounding
    of another batch size)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path, model = reference_pth
    out = evaluate_torch.main(["--config", os.path.join(REPO, "configs", "tiny_smoke.yaml"), "--weight", path,
                               "--dataset", "synthetic", "--platform", CPU, "--exp_dir", str(tmp_path),
                               "--no_save_top_k"])
    assert out["num_pairs"] == 2 and 0 <= out["recall_at_1"] <= 100
    scene = out["test_ds"].scene
    want = serving.build_forward_fn(model, CPU)(scene.get_clouds([0, 1, 2])[0])
    np.testing.assert_allclose(scene.global_descs[:3], want.numpy(), atol=1e-6)


def test_parity_harness_self_diff(tmp_path, capsys, reference_pth):
    """``parity_harness_torch.py`` on the synthetic scene from a reference
    ``.pth``: its log parses as the reference's, and a second run diffed
    against the first passes with a zero delta on every trip pair."""
    argv = ["--config", os.path.join(REPO, "configs", "tiny_smoke.yaml"), "--weight", reference_pth[0],
            "--dataset", "synthetic", "--platform", CPU]
    assert parity_harness_torch.main(argv) == 0
    log = tmp_path / "ours.log"
    log.write_text(capsys.readouterr().out)
    pairs = parity_harness_torch.parse_reference_log(str(log))
    assert set(pairs) == {("trip_0", "trip_1"), ("trip_1", "trip_0")}
    assert all(len(v["recall"]) == 25 and "opr" in v for v in pairs.values())
    report = tmp_path / "report.json"
    assert parity_harness_torch.main(argv + ["--reference-log", str(log), "--out", str(report)]) == 0
    assert "PARITY: PASS" in capsys.readouterr().out
    diffs = json.loads(report.read_text())["diffs"]
    assert len(diffs) == 2 and all(d["max_abs_d_recall"] == 0 and d["d_one_percent"] == 0 for d in diffs.values())
    shifted = tmp_path / "shifted.log"
    shifted.write_text(log.read_text().replace("Recall@top1%(=1): ", "Recall@top1%(=1): 5"))
    assert parity_harness_torch.main(argv + ["--reference-log", str(shifted)]) == 1


def test_train_cli_prints_flops(tmp_path, monkeypatch):
    """``train_torch.py --print-flops`` logs the forward's GFLOPs per cloud
    (the products' and convolutions', two per multiply-add, on a probe of
    4 clouds) and the parameter table per top-level module."""
    import logging

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("patchaugnet_tpu_torch")
    logger.addHandler(handler)
    try:
        run = train_torch.main(["--config", os.path.join(REPO, "configs", "tiny_smoke.yaml"), "--dataset", "synthetic",
                                "--platform", CPU, "--epochs", "0", "--exp_dir", str(tmp_path), "--print-flops"])
    finally:
        logger.removeHandler(handler)
    flops = [r for r in records if r.startswith("FLOPs: ")]
    table = [r for r in records if r.startswith("Parameter table: ")]
    assert len(flops) == 1 and float(flops[0].split()[1]) > 0
    model = run["state"].model
    assert len(table) == 1 and f"'TOTAL': {sum(p.numel() for p in model.parameters())}" in table[0]


def test_profiling_utils():
    """``utils.flops`` counts two FLOPs per multiply-add of a product,
    ``parameter_count`` sums per top-level module, ``DeviceTimer`` times
    on the host's clock on the CPU."""
    from patchaugnet_tpu_torch.utils import DeviceTimer, flops, parameter_count

    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4, bias=False))
    x = torch.zeros(5, 8)
    with torch.no_grad():
        assert flops(net, x) == 2 * 5 * (8 * 16 + 16 * 4)
    assert parameter_count(net) == {"0": 8 * 16 + 16, "1": 0, "2": 16 * 4, "TOTAL": 8 * 16 + 16 + 16 * 4}
    timer = DeviceTimer(CPU)
    for _ in range(3):
        assert timer.timed_call(net, x).shape == (5, 4)
    stats = timer.stats()
    assert stats["n"] == 2 and stats["mean_ms"] >= 0 and len(timer.times_ms) == 3
