"""The port's ``utils`` remainder against the JAX package's, on the CPU.

- ``utils/geometry.py``: every function on seeded inputs. The IoUs,
  overlap ratios, rotations, transforms, pose errors, ``nn_dist`` and
  ``voxel_downsample`` equal; ``get_overlap_indices``' two index sets
  equal (cKDTree against sklearn's KDTree: the same exact float64
  distances at the ``max_dist`` border); ``icp_point_to_point`` within
  1e-12 of the JAX transform (measured: equal) and 1e-9 of the true one,
  its RMSE within 1e-12; ``nn_angle`` on the CPU within 1e-6 of the JAX
  ``nn_angle`` (measured: equal), with a duplicate point (a tie) in it;
- ``utils/visualization.py``: each plot pixel-equal to the JAX module's
  (the same matplotlib calls on the same data), ``compare_pose_errors``
  equal;
- ``utils.profiling.trace`` on the CPU: the Chrome trace it writes names
  the ``pan::fps`` and ``pan::knn`` calls made inside it;
- ``data`` and ``utils`` export every name that the JAX package's do;
- a subprocess where protobuf, sklearn, pandas, PyYAML, matplotlib and
  JAX do not import, as on the card's machine: the .pb codec round-trips,
  the geometry runs, ``compare_pose_errors`` runs, a plot raises an
  ``ImportError`` that names matplotlib.
"""
import json
import os
import subprocess
import sys

import matplotlib
import matplotlib.image
import numpy as np
import pytest
import torch

from patchaugnet_tpu import data as jdata
from patchaugnet_tpu import utils as jutils
from patchaugnet_tpu.utils import geometry as jgeo
from patchaugnet_tpu.utils import visualization as jvis

from patchaugnet_tpu_torch import data, ops, utils
from patchaugnet_tpu_torch.data import pointclouds
from patchaugnet_tpu_torch.utils import geometry, visualization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICP_TOL = 1e-12                      # the port's ICP transform and RMSE against the JAX package's
ICP_TRUTH_TOL = 1e-9                 # the recovered transform against the one applied
ANGLE_TOL = 1e-6                     # nn_angle's cosines against the JAX package's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _boxes():
    rng = np.random.RandomState(3)
    out = []
    for _ in range(6):
        lo = rng.rand(3) * 4
        out.append([*lo, *(lo + rng.rand(3) * 3 + 0.1)])
    out.append([0, 0, 0, 1, 1, 1])
    out.append([2, 2, 2, 3, 3, 3])                         # disjoint from the one before
    return out


@pytest.mark.parametrize("what", ["iou_2d", "iou_3d"])
def test_ious(what):
    boxes = _boxes()
    for a in boxes:
        for b in boxes:
            if what == "iou_2d":
                a2, b2 = [a[0], a[1], a[3], a[4]], [b[0], b[1], b[3], b[4]]
                assert geometry.iou_2d(a2, b2) == jgeo.iou_2d(a2, b2)
            else:
                assert geometry.iou_3d(a, b) == jgeo.iou_3d(a, b)


@pytest.mark.parametrize("use_2d,use_grid,res", [(True, True, 1.0), (False, True, 0.5), (True, False, 1.0),
                                                 (False, False, 2.0)])
def test_compute_overlap_ratio(use_2d, use_grid, res):
    rng = np.random.RandomState(4)
    a = rng.rand(500, 3) * 10
    for shift in (0.0, 3.0, 20.0):
        b = rng.rand(400, 3) * 10 + shift
        got = geometry.compute_overlap_ratio(a, b, use_2d, use_grid, res)
        assert got == jgeo.compute_overlap_ratio(a, b, use_2d, use_grid, res)


def _pair(seed, n=600, degrees=4.0, shift=(0.03, -0.02, 0.01)):
    """A submap-like cloud and its image under a known rigid transform."""
    src = pointclouds.synthetic_scene_clouds(np.random.RandomState(seed), 1, n)[0]
    transform = np.eye(4)
    transform[:3, :3] = jgeo.rotation_matrix_z(np.radians(degrees))
    transform[:3, 3] = shift
    return src, jgeo.apply_transform(src, transform), transform


def test_rotations_transforms_and_pose_errors():
    src, tgt, transform = _pair(0)
    np.testing.assert_array_equal(geometry.rotation_matrix_z(0.3), jgeo.rotation_matrix_z(0.3))
    np.testing.assert_array_equal(geometry.apply_transform(src, transform), tgt)
    r2 = jgeo.rotation_matrix_z(0.31)
    assert geometry.relative_rotation_error(transform[:3, :3], r2) == jgeo.relative_rotation_error(
        transform[:3, :3], r2)
    assert geometry.relative_translation_error([1, 2, 3], [1.5, 2, 2]) == jgeo.relative_translation_error(
        [1, 2, 3], [1.5, 2, 2])


@pytest.mark.parametrize("shape", [(40, 3), (3, 40, 3)], ids=["one cloud", "batch"])
def test_nn_dist(shape):
    c = np.random.RandomState(5).rand(*shape)
    np.testing.assert_array_equal(geometry.nn_dist(c), jgeo.nn_dist(c))


@pytest.mark.parametrize("voxel", [0.5, 2.0])
def test_voxel_downsample(voxel):
    pts = (np.random.RandomState(6).rand(700, 3) * 10).astype(np.float32)
    got = geometry.voxel_downsample(pts, voxel)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jgeo.voxel_downsample(pts, voxel))


@pytest.mark.parametrize("max_dist", [0.05, 0.2, 1.0])
def test_get_overlap_indices_sets_equal(max_dist):
    rng = np.random.RandomState(7)
    a = rng.rand(400, 3) * 4
    b = np.concatenate([a[:200] + rng.randn(200, 3) * 0.1, rng.rand(200, 3) * 4 + 3])
    got = geometry.get_overlap_indices(a, b, max_dist)
    want = jgeo.get_overlap_indices(a, b, max_dist)
    assert got == want
    assert 0 < len(got[0]) < 400 and 0 < len(got[1]) < 400


@pytest.mark.parametrize("seed,degrees", [(0, 4.0), (1, -8.0)])
def test_icp_recovers_a_known_transform(seed, degrees):
    src, tgt, transform = _pair(seed, degrees=degrees)
    got, rmse = geometry.icp_point_to_point(src, tgt)
    want, want_rmse = jgeo.icp_point_to_point(src, tgt)
    np.testing.assert_allclose(got, want, rtol=0, atol=ICP_TOL)
    assert abs(rmse - want_rmse) <= ICP_TOL
    np.testing.assert_allclose(got, transform, rtol=0, atol=ICP_TRUTH_TOL)
    init = np.eye(4)
    init[:3, 3] = [0.5, 0, 0]                              # an initial guess far off: ICP from there
    np.testing.assert_allclose(geometry.icp_point_to_point(src, tgt, init, max_iterations=5)[0],
                               jgeo.icp_point_to_point(src, tgt, init, max_iterations=5)[0], rtol=0, atol=ICP_TOL)


def test_nn_angle_matches_the_jax_package():
    c = np.random.RandomState(9).rand(2, 48, 3).astype(np.float32)
    c[:, 7] = c[:, 2]                                       # a duplicate: a tie in the kNN
    want = jgeo.nn_angle(c, 3)
    got = geometry.nn_angle(c, 3, device="cpu")
    assert got.shape == want.shape == (2, 3, 48, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_TOL)
    np.testing.assert_allclose(geometry.nn_angle(c[0], 3, device="cpu"), want[:1], rtol=0, atol=ANGLE_TOL)


PLOTS = {
    "recall curves": lambda m, out: m.plot_recall_curves(
        {"a": np.linspace(40, 90, 25), "b": np.linspace(30, 95, 25) ** 0.9}, out, title="t"),
    "t-SNE": lambda m, out: m.plot_tsne_features(
        np.random.RandomState(10).randn(40, 8), np.arange(40) % 4, out),
    "t-SNE without labels": lambda m, out: m.plot_tsne_features(np.random.RandomState(11).randn(24, 6), None, out),
    "clouds": lambda m, out: m.plot_clouds(
        [np.random.RandomState(12).rand(300, 3), np.random.RandomState(13).rand(200, 3)], out, labels=["x", "y"]),
}


@pytest.mark.parametrize("plot", list(PLOTS))
def test_plots_pixel_equal_to_the_jax_package(tmp_path, plot):
    want = PLOTS[plot](jvis, str(tmp_path / "jax" / "p.png"))
    got = PLOTS[plot](visualization, str(tmp_path / "port" / "p.png"))
    assert got == str(tmp_path / "port" / "p.png")
    a, b = matplotlib.image.imread(got), matplotlib.image.imread(want)
    assert a.shape == b.shape and a.shape[0] > 100
    np.testing.assert_array_equal(a, b)


def test_compare_pose_errors():
    a = np.random.RandomState(14).rand(9, 2)
    b = np.random.RandomState(15).rand(5, 2)
    assert visualization.compare_pose_errors(a, b, ("x", "y")) == jvis.compare_pose_errors(a, b, ("x", "y"))


def test_trace_on_the_cpu_names_the_kernel_ops(tmp_path):
    x = torch.from_numpy(np.random.RandomState(16).rand(2, 256, 3).astype(np.float32))
    with utils.trace(str(tmp_path / "trace"), device="cpu") as prof:
        idx = ops.farthest_point_sample(x, 32)
        ops.knn(x, ops.gather(x, idx), 8)
        ops.knn(x, ops.gather(x, idx), 3)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace") and os.path.exists(prof.trace_path)
    with open(prof.trace_path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("pan::fps") == 1 and names.count("pan::knn") == 2


def test_data_and_utils_export_every_name_of_the_jax_package():
    for jmod, mod in ((jdata, data), (jutils, utils)):
        missing = sorted(set(jmod.__all__) - set(mod.__all__))
        assert not missing, f"{mod.__name__} lacks {missing}"
        assert all(hasattr(mod, name) for name in mod.__all__)


# the card machine's missing packages: these do not import
_BLOCKED = """
import sys
for name in ("pandas", "sklearn", "yaml", "google.protobuf", "matplotlib", "tensorboard", "jax", "jaxlib",
             "flax", "patchaugnet_tpu"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from patchaugnet_tpu_torch import data, utils
from patchaugnet_tpu_torch.utils import geometry, visualization

path = sys.argv[2]
entries = {3: [data.OverlapEntry(0, [1, 2**32 - 1], [], [5])], 0: [data.OverlapEntry(7, [], [9], [])]}
data.save_overlap_pb(path, entries, query_idx=4)
back = data.load_overlap_pb(path)
assert {p: [(e.idx1, e.near_indices2, e.far_indices2, e.bad_far_indices2) for e in v] for p, v in back.items()} == {
    3: [(0, [1, 2**32 - 1], [], [5])], 0: [(7, [], [9], [])]}
rng = np.random.RandomState(0)
a = rng.rand(300, 3)
t = np.eye(4)
t[:3, :3] = geometry.rotation_matrix_z(0.05)
t[:3, 3] = [0.01, 0.02, 0.0]
b = geometry.apply_transform(a, t)
assert len(geometry.get_overlap_indices(a, b, 0.05)[0]) > 0
found, _ = geometry.icp_point_to_point(a, b)
assert np.abs(found - t).max() < 1e-9
assert geometry.nn_angle(a[:32], 3, device="cpu").shape == (1, 3, 32, 32)
assert 0 < geometry.compute_overlap_ratio(a * 10, b * 10) <= 1
assert visualization.compare_pose_errors([(1.0, 2.0)], [(3.0, 4.0)])["b"]["rte_mean"] == 4.0
try:
    visualization.plot_recall_curves({"a": [1.0, 2.0]}, path + ".png")
except ImportError as e:
    assert "matplotlib" in str(e), e
else:
    raise AssertionError("a plot ran without matplotlib")
assert sys.modules.get("google.protobuf") is None and sys.modules.get("sklearn") is None
print("blocked run ok")
"""


def test_runs_without_the_missing_packages(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, REPO, str(tmp_path / "q.pb")], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "blocked run ok" in proc.stdout
