"""The port's PatchAugNet descriptor forward against the JAX package.

A JAX ``PatchAugNet`` at a tiny configuration is initialised on the CPU,
its BN statistics are replaced by random numpy values, and its variables
are carried into the port with ``load_jax_variables``; both run in eval
mode on the same numpy clouds. Also: the serving entry points, the
config copy, and that no port module imports JAX or the JAX package.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from patchaugnet_tpu.models import PatchAugNet as JaxPatchAugNet

from patchaugnet_tpu_torch import configs, serving, train
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.models import PatchAugNet, get_model
from patchaugnet_tpu_torch.nn import BatchNorm, seeded_init_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(configs.PATCH_AUG_NET, NUM_POINTS=128, SAMPLING=[32, 8, 4], KNN=[8, 8, 4],
            MAX_SAMPLES=[8, 32, 128])


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


@pytest.fixture(scope="module")
def carried():
    """(clouds, JAX output, port model with the same weights)."""
    rng = np.random.RandomState(0)
    clouds = rng.rand(3, TINY["NUM_POINTS"], 3).astype(np.float32)
    jm = JaxPatchAugNet(param=TINY, use_a2a_recon=False)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(clouds)))
    variables = {"params": variables["params"],
                 "batch_stats": _random_batch_stats(variables["batch_stats"], rng)}
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(clouds))
    model = load_jax_variables(PatchAugNet(TINY), variables).eval()
    return clouds, ref, model


def test_forward_matches_jax(carried):
    """Provenance indices exactly equal; descriptors and FP features
    within 1e-4 (measured max abs difference: 8.9e-8 on the descriptor,
    3.0e-7 on the FP features)."""
    clouds, ref, model = carried
    with torch.inference_mode():
        out = model(torch.from_numpy(clouds))
    assert out.global_desc.shape == (3, 256)
    for want, got in zip(ref.center_idx_origin, out.center_idx_origin):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for want, got in zip(ref.sample_idx_origin, out.sample_idx_origin):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_allclose(np.asarray(ref.global_desc), out.global_desc.numpy(), atol=1e-4)
    for want, got in zip(ref.fp_features, out.fp_features):
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out.global_desc.numpy(), axis=-1), 1.0, rtol=1e-5)


def test_serving_entry_points_on_cpu(carried):
    clouds, ref, model = carried
    fwd = serving.build_forward_fn(model, device="cpu")
    desc = fwd(clouds)
    assert desc.shape == (3, 256) and desc.device.type == "cpu"
    np.testing.assert_allclose(np.asarray(ref.global_desc), desc.numpy(), atol=1e-4)
    g, local, centers = serving.build_local_forward_fn(model, device="cpu")(torch.from_numpy(clouds))
    assert torch.equal(g, desc)
    np.testing.assert_allclose(np.asarray(ref.fp_features[-2]), local.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(ref.center_idx_origin[0]), centers.numpy())


def test_serving_forward_runs_in_eval_mode_after_a_train_step():
    """C-2: the forward built before training serves descriptors in eval
    mode after a real train step left the model in train mode, equal to a
    freshly prepared eval forward's, and changes no BatchNorm statistic;
    the model is back in train mode after the call."""
    cfg = dict(configs.PATCH_AUG_NET_TRAIN, **TINY, TRAIN_BATCH_SIZE=1, TRAIN_NEGATIVES_PER_QUERY=1,
               A2B_MAX_ROWS=64, A2B_MAX_PAIRS=4)
    model = seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(3))
    state = train.create_train_state(model, cfg, device="cpu")
    forward = serving.build_forward_fn(state.model, device="cpu")
    clouds = torch.from_numpy(np.random.RandomState(4).rand(5, cfg["NUM_POINTS"], 3).astype(np.float32))
    corr, mask = train.empty_patch_inputs(cfg, 5)
    mask[:3] = True
    state, _ = train.build_train_step(state.model, cfg)(state, clouds, corr, mask)
    assert state.model.training
    stats = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
    fresh = copy.deepcopy(state.model)
    desc = forward(clouds)
    assert state.model.training
    for key, value in state.model.state_dict().items():
        if "running" in key:
            assert torch.equal(value, stats[key]), key
    assert torch.equal(desc, serving.build_forward_fn(fresh, device="cpu")(clouds))
    g, _, _ = serving.build_local_forward_fn(state.model, device="cpu")(clouds)
    assert torch.equal(g, desc) and state.model.training


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.build_forward_fn(PatchAugNet(TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.resolve_device("cuda")


def test_unported_options_raise():
    with pytest.raises(ValueError, match="unknown model_type"):
        get_model("pointnet", TINY)
    # COMPUTE_DTYPE, KNN_APPROX_RECALL and REMAT are ported (tests/test_torch_precision.py)
    model = PatchAugNet(TINY)
    # the patch branch and train-mode BatchNorm are ported (tests/test_torch_train.py);
    # a model built without a decoder reconstructs nothing
    out = model.eval()(torch.rand(2, 128, 3), with_patches=True)
    assert out.patch_data.reconstructed_patches is None
    assert out.patch_data.origin_patches.shape == (2, TINY["SAMPLING"][0], TINY["KNN"][0], 3)
    assert BatchNorm(4)(torch.zeros(2, 4)).shape == (2, 4)   # a fresh module is in train mode


def test_seeded_init_is_reproducible_and_exercises_bn():
    a = seeded_init_(get_model("patch_aug_net", TINY), torch.Generator().manual_seed(7))
    b = seeded_init_(get_model("patch_aug_net", TINY), torch.Generator().manual_seed(7))
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    bn = a.sa0.mlp.bn0
    assert not torch.allclose(bn.running_var, torch.ones_like(bn.running_var))
    assert not torch.allclose(bn.running_mean, torch.zeros_like(bn.running_mean))


def test_config_copy_matches_yaml():
    from __graft_entry__ import FULL_PARAM

    with open(os.path.join(REPO, "configs", "patch_aug_net.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert set(configs.PATCH_AUG_NET) == set(FULL_PARAM)
    assert configs.PATCH_AUG_NET == {key: cfg[key] for key in configs.PATCH_AUG_NET}
    # the training keys: patch losses and weights, the tuple batch,
    # optimizer and schedule, margins, loss flags, a2b table sizes; and the
    # keys the CLIs read: the whole file
    assert configs.PATCH_AUG_NET_TRAIN == {key: cfg[key] for key in configs.PATCH_AUG_NET_TRAIN}
    assert set(configs.PATCH_AUG_NET_TRAIN) - set(configs.PATCH_AUG_NET) == {
        "use_hard_negative_patch_mining", "weight_place_recognition", "weight_patch_recon",
        "weight_patch_feature_contrast", "TRAIN_BATCH_SIZE", "TRAIN_POSITIVES_PER_QUERY",
        "TRAIN_NEGATIVES_PER_QUERY", "BASE_LEARNING_RATE", "MOMENTUM", "OPTIMIZER", "MAX_EPOCH",
        "LEARNING_RATE_DECAY", "MARGIN_1", "MARGIN_2", "LOSS_FUNCTION", "LOSS_LAZY",
        "TRIPLET_USE_BEST_POSITIVES", "LOSS_IGNORE_ZERO_BATCH", "A2B_MAX_ROWS", "A2B_MAX_PAIRS",
        "EXP_DIR", "MANUAL_SEED", "DATA_AUGMENTATION", "EVAL_BATCH_SIZE", "EVAL_POSITIVES_PER_QUERY",
        "EVAL_NEGATIVES_PER_QUERY", "USE_SPA_ATT_AFTER_FP", "dataset"}
    assert configs.PATCH_AUG_NET_TRAIN == cfg
    with open(os.path.join(REPO, "configs", "tiny_smoke.yaml")) as f:
        assert configs.TINY_SMOKE == yaml.safe_load(f)
    # PPT-Net, PointNetVLAD and MinkLoc3Dv2: every key of their files
    for name, copy_ in (("pptnet_origin.yaml", configs.PPTNET_ORIGIN), ("pointnet_vlad.yaml", configs.POINTNET_VLAD),
                        ("minkloc3dv2.yaml", configs.MINKLOC3DV2)):
        with open(os.path.join(REPO, "configs", name)) as f:
            assert copy_ == yaml.safe_load(f), name
        assert configs.KNOWN_CONFIGS[name] is copy_
    assert set(configs.KNOWN_CONFIGS) == {"patch_aug_net.yaml", "tiny_smoke.yaml", "pptnet_origin.yaml",
                                          "pointnet_vlad.yaml", "minkloc3dv2.yaml"}


_IMPORT_EVERY_MODULE = """
import sys, pkgutil, importlib
# the JAX side, and the packages the card's machine lacks
blocked = ("jax", "jaxlib", "flax", "patchaugnet_tpu", "__graft_entry__", "pandas", "sklearn", "yaml",
           "google.protobuf")
for name in blocked:
    sys.modules[name] = None
import patchaugnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(patchaugnet_tpu_torch.__path__, "patchaugnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for script in ("train_torch", "evaluate_torch", "create_dataset_torch", "export_serving_torch", "parity_harness_torch"):
    importlib.import_module(script)
leaked = [m for m in sys.modules if (m.split(".")[0] in blocked or m.startswith("google.protobuf"))
          and sys.modules[m] is not None]
assert not leaked, leaked
for name in ("train", "train.state", "train.step", "losses.metric", "losses.patch_contrast", "nn.pointnet",
             "train.loop", "data", "data.dataset_info", "data.pointclouds", "data.retrieval", "data.overlap",
             "data.query_overlap_pb2", "data.scene_dataset", "data.tuple_dataset", "utils",
             "utils.logging_util", "utils.meters", "utils.timestamps", "models.pptnet", "models.pointnet_vlad",
             "nn.attention", "nn.vlad", "ops.library", "compat.torch_loader", "utils.profiling"):
    assert "patchaugnet_tpu_torch." + name in names, name
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module and the five root ``*_torch.py`` scripts import
    with jax, flax and patchaugnet_tpu blocked in ``sys.modules`` (an
    exact-name block, not a prefix match: ``patchaugnet_tpu`` is a prefix
    of ``patchaugnet_tpu_torch``), the slices' modules among them; and with
    pandas, sklearn, PyYAML and protobuf blocked, as the card's machine
    lacks them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_EVERY_MODULE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 37
