"""The port's PatchAugNet descriptor forward against the JAX package.

A JAX ``PatchAugNet`` at a tiny configuration is initialised on the CPU,
its BN statistics are replaced by random numpy values, and its variables
are carried into the port with ``load_jax_variables``; both run in eval
mode on the same numpy clouds. Also: the serving entry points, the
config copy, and that no port module imports JAX or the JAX package.
"""
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


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.build_forward_fn(PatchAugNet(TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.resolve_device("cuda")


def test_unported_options_raise():
    with pytest.raises(ValueError, match="not ported"):
        get_model("pptnet", TINY)
    for key, value in (("COMPUTE_DTYPE", "bfloat16"), ("KNN_APPROX_RECALL", 0.95)):
        with pytest.raises(NotImplementedError, match=key):
            PatchAugNet(dict(TINY, **{key: value}))
    # the train step's options that are not ported
    model = PatchAugNet(TINY)
    with pytest.raises(NotImplementedError, match="REMAT"):
        train.build_train_step(model, dict(configs.PATCH_AUG_NET_TRAIN, REMAT=True))
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
    # optimizer and schedule, margins, loss flags, a2b table sizes
    assert configs.PATCH_AUG_NET_TRAIN == {key: cfg[key] for key in configs.PATCH_AUG_NET_TRAIN}
    assert set(configs.PATCH_AUG_NET_TRAIN) - set(configs.PATCH_AUG_NET) == {
        "use_hard_negative_patch_mining", "weight_place_recognition", "weight_patch_recon",
        "weight_patch_feature_contrast", "TRAIN_BATCH_SIZE", "TRAIN_POSITIVES_PER_QUERY",
        "TRAIN_NEGATIVES_PER_QUERY", "BASE_LEARNING_RATE", "MOMENTUM", "OPTIMIZER", "MAX_EPOCH",
        "LEARNING_RATE_DECAY", "MARGIN_1", "MARGIN_2", "LOSS_FUNCTION", "LOSS_LAZY",
        "TRIPLET_USE_BEST_POSITIVES", "LOSS_IGNORE_ZERO_BATCH", "A2B_MAX_ROWS", "A2B_MAX_PAIRS"}


_IMPORT_EVERY_MODULE = """
import sys, pkgutil, importlib
for name in ("jax", "jaxlib", "flax", "patchaugnet_tpu", "__graft_entry__"):
    sys.modules[name] = None
import patchaugnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(patchaugnet_tpu_torch.__path__, "patchaugnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "patchaugnet_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
for name in ("train", "train.state", "train.step", "losses.metric", "losses.patch_contrast", "nn.pointnet"):
    assert "patchaugnet_tpu_torch." + name in names, name
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module imports with jax, flax and patchaugnet_tpu
    blocked in ``sys.modules`` (an exact-name block, not a prefix match:
    ``patchaugnet_tpu`` is a prefix of ``patchaugnet_tpu_torch``), the
    train slice's among them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_EVERY_MODULE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 21
