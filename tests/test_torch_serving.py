"""The port's serving artifact (``serving.export_descriptor_fn``,
``save_artifact``, ``load_artifact``) and ``export_serving_torch.py``, on
the CPU, mirroring the JAX package's ``tests/test_serving.py``.

An artifact holds the eval forward with its weights, as a
``torch.export`` program whose FPS and kNN calls are single
``pan.fps`` / ``pan.knn`` nodes. On the CPU it computes the live forward's
ops in the live forward's order, so its outputs equal the live forward's
exactly; the live forward is within 1e-4 of the JAX forward on carried
weights. The PatchAugNet is ``configs/tiny_smoke.yaml``'s (128 points),
exported by ``export_serving_torch.py`` from a reference ``.pth``; PPT-Net,
PointNetVLAD and MinkLoc3Dv2 are exported at tiny widths from their
seeded initialisation.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu.models import get_model as jax_get_model

from patchaugnet_tpu_torch import configs, serving
from patchaugnet_tpu_torch.compat import load_torch_checkpoint, reference_state_dict, to_jax_variables
from patchaugnet_tpu_torch.models import get_model
from patchaugnet_tpu_torch.nn import seeded_init_

import export_serving_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
CFG_PATH = os.path.join(REPO, "configs", "tiny_smoke.yaml")
TINY = configs.TINY_SMOKE
MINKLOC = dict(configs.MINKLOC3DV2, planes=[8, 8], layers=[1, 1], num_top_down=1, feature_size=32, output_dim=16,
               quantization_step=0.05)
PNV = dict(configs.POINTNET_VLAD, NUM_POINTS=64)
FAMILIES = {"pptnet": dict(configs.PPTNET_ORIGIN, NUM_POINTS=128, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4],
                           FEATURE_SIZE=[32] * 4, OUTPUT_DIM=[32] * 4, CLUSTER_SIZE=[1, 2, 4, 8],
                           MAX_SAMPLES=[8, 16, 32, 128]),
            "pointnet_vlad": PNV}
DESC_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread_quick_compiles():
    threads = torch.get_num_threads()
    optimise = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimise)
    torch.set_num_threads(threads)


def _random_tree(tree, rng):
    """Every leaf redrawn from ``rng``: scales and variances in [0.5, 1.5],
    the rest normal with std 0.2."""
    return {k: _random_tree(v, rng) if isinstance(v, dict) else
            ((rng.rand(*v.shape) + 0.5) if k in ("scale", "var") else rng.randn(*v.shape) * 0.2).astype(np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``export_serving_torch.py`` in this process on the tiny configuration
    (``configs/tiny_smoke.yaml``), from a reference ``.pth`` of random
    weights, at batch 2, both flavours. Returns the artifacts' paths, the
    live model fed the same ``.pth``, clouds, and the JAX global
    descriptors on those weights, and each artifact loaded
    (``serving.load_artifact``)."""
    tmp = tmp_path_factory.mktemp("serving")
    rng = np.random.RandomState(0)
    clouds = rng.rand(2, TINY["NUM_POINTS"], 3).astype(np.float32)
    variables = _random_tree(to_jax_variables(get_model("patch_aug_net", TINY)), rng)
    pth = str(tmp / "ref.pth")
    torch.save({"state_dict_encoder": {k: torch.from_numpy(v) for k, v in
                                       reference_state_dict("patch_aug_net", variables).items()}}, pth)
    paths = export_serving_torch.main(["--config", CFG_PATH, "--weight", pth, "--out", str(tmp / "out"),
                                       "--batch_sizes", "2", "--with_local", "--platform", CPU])
    live = load_torch_checkpoint(pth, "patch_aug_net", TINY, get_model("patch_aug_net", TINY))
    jm = jax_get_model("patch_aug_net", TINY)
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False).global_desc,
                  compiler_options={"xla_cpu_use_fusion_emitters": False})
    want = np.asarray(fwd(variables, jnp.asarray(clouds)))
    loaded = {flavour: serving.load_artifact(path) for flavour, path in zip(("desc", "local"), paths)}
    return dict(zip(("desc", "local"), paths)), live, clouds, want, loaded


def _ops(exported):
    return [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]


def test_global_artifact_matches_live_forward(exported):
    """The global artifact's descriptors equal the live forward's on the
    same ``.pth``, and lie within DESC_TOL of the JAX forward's on those
    weights; its sidecar describes it."""
    paths, live, clouds, want, loaded = exported
    fwd, meta = loaded["desc"]
    got = fwd(clouds)
    assert torch.equal(got, serving.build_forward_fn(live, CPU)(clouds))
    np.testing.assert_allclose(got.numpy(), want, atol=DESC_TOL)
    assert meta["format"] == "patchaugnet-tpu-torch-serving/1" and meta["model_type"] == "patch_aug_net"
    assert meta["bytes"] == os.path.getsize(paths["desc"]) and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__ and meta["weight"].endswith("ref.pth")
    assert meta["flavour"] == "desc" and meta["batch_size"] == 2 and meta["n_points"] == 128
    assert meta["inputs"] == [{"shape": [2, 128, 3], "dtype": "float32"}]
    assert meta["outputs"] == [{"shape": list(want.shape), "dtype": "float32"}]
    assert meta["export_seconds"] > 0


def test_graph_holds_one_pan_op_per_launch(exported):
    """The tiny PatchAugNet's program: 3 ``pan.fps`` (the SA levels) and 6
    ``pan.knn`` nodes (the SA levels' kNN and the FP levels' 3-NN), no
    unrolled FPS loop or top-k sweep."""
    names = [str(n.target) for n in exported[4]["desc"][0].program.graph.nodes if n.op == "call_function"]
    assert sum(n == "pan.fps.default" for n in names) == 3
    assert sum(n == "pan.knn.default" for n in names) == 6
    assert len(names) < 1000


def test_local_artifact_matches_live_forward(exported):
    _, live, clouds, _, loaded = exported
    fwd, meta = loaded["local"]
    got = fwd(clouds)
    for g, w in zip(got, serving.build_local_forward_fn(live, CPU)(clouds), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[2].dtype == torch.int32 and len(meta["outputs"]) == 3 and meta["flavour"] == "local"


def test_cli_writes_loadable_artifacts(exported):
    """One artifact per flavour, named by model, flavour and batch size,
    each loadable and finite."""
    paths, loaded = exported[0], exported[4]
    assert [os.path.basename(p) for p in paths.values()] == ["patch_aug_net_desc_b2.pt2", "patch_aug_net_local_b2.pt2"]
    for flavour, n_out in (("desc", 1), ("local", 3)):
        fwd, meta = loaded[flavour]
        got = fwd(np.zeros((2, 128, 3), np.float32))
        got = got if isinstance(got, tuple) else (got,)
        assert meta["flavour"] == flavour and len(got) == n_out
        assert all(bool(torch.isfinite(a.float()).all()) for a in got)


def test_batch_size_is_baked_into_the_artifact(exported):
    fwd, _ = exported[4]["desc"]
    with pytest.raises(ValueError, match="shape"):
        fwd(np.zeros((3, TINY["NUM_POINTS"], 3), np.float32))


@pytest.mark.parametrize("model_type, cfg", [("pointnet_vlad", PNV), ("minkloc3dv2", MINKLOC)])
def test_local_export_rejects_models_without_locals(model_type, cfg):
    with pytest.raises(ValueError, match="no local descriptors"):
        serving.export_descriptor_fn(get_model(model_type, cfg), 2, 64, with_local=True, device=CPU)


def test_minkloc_sparse_export_roundtrip(tmp_path):
    """The sparse voxel-table forward (sorts, searchsorted kernel maps,
    cumsums and scatters at static capacities) exports and reloads. The
    model, left in train mode, is traced in eval mode and left in train
    mode."""
    model = seeded_init_(get_model("minkloc3dv2", MINKLOC), torch.Generator().manual_seed(0)).train()
    assert model.backend == "sparse"
    clouds = np.random.RandomState(1).rand(2, 128, 3).astype(np.float32) * 2 - 1
    path = str(tmp_path / "mls.pt2")
    serving.save_artifact(serving.export_descriptor_fn(model, 2, 128, device=CPU), path, {"model_type": "minkloc3dv2"})
    assert model.training
    fwd, meta = serving.load_artifact(path)
    assert meta["model_type"] == "minkloc3dv2"
    assert torch.equal(fwd(clouds), serving.build_forward_fn(model, CPU)(clouds))


@pytest.mark.parametrize("model_type", ["pptnet", "pointnet_vlad"])
def test_family_artifact_matches_live_forward(model_type, tmp_path):
    """The other dense families' global artifacts equal their live
    forwards; PPT-Net's program holds one ``pan.fps`` per SA level (4) and
    one ``pan.knn`` per SA and FP level (8), PointNetVLAD's none."""
    cfg = FAMILIES[model_type]
    model = seeded_init_(get_model(model_type, cfg), torch.Generator().manual_seed(2))
    clouds = np.random.RandomState(3).rand(2, cfg["NUM_POINTS"], 3).astype(np.float32)
    path = str(tmp_path / f"{model_type}.pt2")
    serving.save_artifact(serving.export_descriptor_fn(model, 2, cfg["NUM_POINTS"], device=CPU), path)
    fwd, _ = serving.load_artifact(path)
    assert torch.equal(fwd(clouds), serving.build_forward_fn(model, CPU)(clouds))
    names = [str(n.target) for n in fwd.program.graph.nodes if n.op == "call_function"]
    launches = (4, 8) if model_type == "pptnet" else (0, 0)
    assert (names.count("pan.fps.default"), names.count("pan.knn.default")) == launches


def test_missing_sidecar_yields_empty_meta(exported, tmp_path):
    paths, live, clouds, _, _ = exported
    path = str(tmp_path / "bare.pt2")
    shutil.copy(paths["desc"], path)
    fwd, meta = serving.load_artifact(path)
    assert meta == {}
    assert torch.equal(fwd(clouds), serving.build_forward_fn(live, CPU)(clouds))


_FRESH_SERVE = """
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from patchaugnet_tpu_torch import serving
fwd, meta = serving.load_artifact(sys.argv[2])
out = fwd(np.load(sys.argv[3]))
np.save(sys.argv[4], out.numpy())
leaked = sorted(m for m in sys.modules if m.startswith("patchaugnet_tpu_torch.")
                and m.split(".")[1] in ("models", "nn", "train", "data"))
assert not leaked, leaked
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
print(meta["model_type"])
"""


def test_fresh_process_serves_without_the_model_code(exported, tmp_path):
    """A new process loads the artifact with torch and the port's ops alone
    (``models``, ``nn``, ``train`` and ``data`` never import), switches
    TF32 off, and serves the live forward's descriptors."""
    paths, model, clouds, _, _ = exported
    path = paths["desc"]
    np.save(tmp_path / "clouds.npy", clouds)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", _FRESH_SERVE, REPO, path, str(tmp_path / "clouds.npy"),
                           str(tmp_path / "out.npy")], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["patch_aug_net"]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), serving.build_forward_fn(model, CPU)(clouds).numpy())
