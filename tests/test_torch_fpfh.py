"""The port's host libraries on the CPU: FPFH (numpy and native), the
native cloud loader, and the g++ build step behind both.

- numpy FPFH and normals: bit-equal to the JAX package's numpy route
  (the same operations), on surfaces, cubes with duplicate points, two
  points and none, with and without given normals;
- native FPFH: built from the same ``csrc/fpfh.cc`` with the same flags,
  bit-equal to the JAX package's native route; within 1e-9 of numpy in
  every row's three 11-bin group sums, as ``tests/test_fpfh.py`` holds
  the JAX pair (rows differ only where a pair sits on a decision
  boundary of the formulation);
- ``compute_fpfh`` takes numpy only when asked (``use_native=False``,
  ``PCR_FPFH_NATIVE=0``); a build that fails raises with g++'s message
  and builds nothing into ``csrc/``;
- ``SceneDataset.get_fpfh[s]``: the JAX package's features, its FIFO
  cache keyed on the radii, cleared by ``_reset``;
- ``fast_loader.load_clouds`` and the native route of ``get_clouds``:
  equal to the JAX loader and to the numpy route, a missing or short file
  a row of zeros.
"""
import os

import numpy as np
import pytest

from patchaugnet_tpu import data as J
from patchaugnet_tpu.data import fast_loader as jloader
from patchaugnet_tpu.data import fpfh as jfpfh
from patchaugnet_tpu.data import fpfh_native as jnative

from patchaugnet_tpu_torch import data as P
from patchaugnet_tpu_torch.data import fast_loader, fpfh, fpfh_native
from patchaugnet_tpu_torch.ops.cuda import _host_build

CPU = "cpu"


def _surface(seed, n=300):
    """A noisy smooth surface (``tests/test_fpfh.py``'s cloud)."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 2 - 1
    z = 0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1]) + 0.02 * rng.randn(n)
    return np.column_stack([xy, z]).astype(np.float32)


def _cube_with_duplicates(seed, n=120):
    pts = np.random.RandomState(seed).rand(n, 3)
    pts[5] = pts[9]
    pts[30] = pts[9]
    return pts


CLOUDS = {
    "surface": (lambda: _surface(0), 0.2),
    "cube with duplicates": (lambda: _cube_with_duplicates(1), 0.25),
    "sparse (few neighbours)": (lambda: _surface(2, 60) * 10, 0.3),
    "two points": (lambda: np.array([[0.0, 0, 0], [0.01, 0.02, 0.0]]), 0.5),
    "no points": (lambda: np.zeros((0, 3)), 0.2),
}


@pytest.mark.parametrize("given_normals", [False, True], ids=["own normals", "given normals"])
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_numpy_route_bit_equal_to_the_jax_package(cloud, given_normals):
    make, radius = CLOUDS[cloud]
    pts = make()
    normals = jfpfh.estimate_normals(pts, radius, 30) if given_normals and len(pts) else None
    want = jfpfh.compute_fpfh(pts, radius, radius, normals=normals, use_native=False)
    got = fpfh.compute_fpfh(pts, radius, radius, normals=normals, use_native=False)
    assert got.dtype == np.float64 and got.shape == (len(pts), fpfh.FPFH_DIM)
    np.testing.assert_array_equal(got, want)
    if len(pts):
        np.testing.assert_array_equal(fpfh.estimate_normals(pts, radius, 30), jfpfh.estimate_normals(pts, radius, 30))


@pytest.mark.parametrize("cloud", ["surface", "cube with duplicates", "sparse (few neighbours)"])
def test_native_route_bit_equal_to_the_jax_package(cloud):
    make, radius = CLOUDS[cloud]
    pts = make()
    got, got_n = fpfh_native.compute_fpfh_native(pts, radius, radius, 30, 100, return_normals=True)
    want, want_n = jnative.compute_fpfh_native(pts, radius, radius, 30, 100, return_normals=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(fpfh.compute_fpfh(pts, radius, radius), got)     # the default route
    assert jnative.available()            # so the JAX package's own default took this route too
    np.testing.assert_array_equal(jfpfh.compute_fpfh(pts, radius, radius), got)


def test_native_within_1e9_of_numpy():
    """``tests/test_fpfh.py::TestNativeFPFH``'s criterion on the port's
    pair: group sums within 1e-9 in every row, 85% of rows within 1e-9
    everywhere, boundary flips moving at most 2% of the mass."""
    pts = _surface(0)
    nrm = fpfh.estimate_normals(pts, 0.2, 30)
    a = fpfh.compute_fpfh(pts, 0.2, 0.2, normals=nrm, use_native=False)
    b = fpfh_native.compute_fpfh_native(pts, 0.2, 0.2, 30, 100, normals=nrm)
    np.testing.assert_allclose(a.reshape(-1, 3, 11).sum(-1), b.reshape(-1, 3, 11).sum(-1), rtol=0, atol=1e-9)
    d = np.abs(a - b)
    assert (d.max(1) <= 1e-9).mean() >= 0.85
    assert d.sum() <= 0.02 * a.sum()


def test_numpy_route_only_when_asked(monkeypatch):
    pts = _surface(3, 80)
    numpy_route = fpfh.compute_fpfh(pts, 0.3, 0.3, use_native=False)
    monkeypatch.setenv("PCR_FPFH_NATIVE", "0")
    calls = []
    monkeypatch.setattr(fpfh_native, "compute_fpfh_native", lambda *a, **k: calls.append(a))
    np.testing.assert_array_equal(fpfh.compute_fpfh(pts, 0.3, 0.3), numpy_route)
    monkeypatch.setenv("PCR_FPFH_NATIVE", "1")
    fpfh.compute_fpfh(pts, 0.3, 0.3)
    assert len(calls) == 1


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """The host-library build pointed at a csrc/ whose fpfh.cc does not compile and a
    build directory of its own."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "fpfh.cc").write_text('extern "C" int compute_fpfh_f64() { return undeclared_name; }\n')
    monkeypatch.setattr(_host_build, "CSRC_DIR", src)
    monkeypatch.setattr(_host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_host_build, "_libs", {})
    return tmp_path


def test_a_failed_build_raises_with_the_compilers_message(broken_build):
    with pytest.raises(RuntimeError, match="undeclared_name"):
        fpfh.compute_fpfh(_surface(0, 20), 0.3, 0.3)
    assert not fpfh_native.available()
    assert os.listdir(broken_build / "csrc") == ["fpfh.cc"]
    assert not [f for f in os.listdir(broken_build / "build") if f.endswith(".so")]
    # numpy still runs when the caller chooses it
    assert fpfh.compute_fpfh(_surface(0, 20), 0.3, 0.3, use_native=False).shape == (20, 33)


def test_no_compiler_raises(broken_build, monkeypatch):
    monkeypatch.setenv("PATH", str(broken_build / "csrc"))
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        fpfh.compute_fpfh(_surface(0, 20), 0.3, 0.3)


def test_libraries_build_outside_csrc():
    """Each library lands in the port's build directory under a name that
    hashes its source and flags; nothing of the port's is in csrc/."""
    for name in _host_build.LIBRARIES:
        path = _host_build.build(name)
        assert path.parent == _host_build.BUILD_DIR and path.exists()
        assert path == _host_build.library_path(name) and len(path.stem.split("-")[-1]) == 16
    ours = [f for f in os.listdir(_host_build.CSRC_DIR) if "-" in f and f.endswith(".so")]
    assert ours == []


def test_scene_get_fpfh_matches_the_jax_package():
    j = J.SceneDataset("synthetic", for_training=True)
    j.create_synthetic(n_trips=2, n_per_trip=4, num_points=64)
    p = P.SceneDataset("synthetic", for_training=True, device=CPU)
    p.create_synthetic(n_trips=2, n_per_trip=4, num_points=64)
    f = p.get_fpfh(0, radius_normal=0.6, radius_feature=0.6)
    np.testing.assert_array_equal(f, j.get_fpfh(0, radius_normal=0.6, radius_feature=0.6))
    assert f.shape == (64, 33) and f.dtype == np.float64 and (f != 0).any()
    assert p.get_fpfh(0, radius_normal=0.6, radius_feature=0.6) is f                 # cached
    assert p.get_fpfh(0, radius_normal=0.6, radius_feature=0.4) is not f             # keyed on the radii
    fs = p.get_fpfhs([0, 3], radius_normal=0.6, radius_feature=0.6)
    assert fs[0] is f
    np.testing.assert_array_equal(fs[1], j.get_fpfhs([0, 3], radius_normal=0.6, radius_feature=0.6)[1])
    p.cache_size = 2
    p.get_fpfh(5, 0.6, 0.6)
    assert len(p._fpfh_cache) == 2 and (0, 0.6, 0.6) not in p._fpfh_cache        # FIFO
    p._reset()
    assert len(p._fpfh_cache) == 0


def _write_bins(root, rng, n_files=5, n_points=64):
    paths = []
    for i in range(n_files):
        path = os.path.join(root, f"{i}.bin")
        (rng.randn(n_points, 3) * 100).astype(np.float64).tofile(path)
        paths.append(path)
    rng.rand(n_points // 2, 3).tofile(os.path.join(root, "short.bin"))
    return paths + [os.path.join(root, "missing.bin"), os.path.join(root, "short.bin")]


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
def test_loader_matches_the_jax_loader_and_numpy(tmp_path, normalize):
    paths = _write_bins(str(tmp_path), np.random.RandomState(0))
    got, meta, ok = fast_loader.load_clouds(paths, 64, normalize=normalize, n_threads=3)
    want, want_meta, want_ok = jloader.load_clouds(paths, 64, normalize=normalize, n_threads=3)
    assert ok == want_ok == 5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(meta, want_meta)
    assert got.dtype == np.float32 and got.shape == (7, 64, 3)
    assert not got[5:].any()                                  # missing and short files: zeros
    if not normalize:
        for i in range(5):
            np.testing.assert_array_equal(got[i], P.load_pc_file(paths[i]).astype(np.float32))


def _oxford_tree(root, n=6, num_points=64):
    """Two Oxford-format trips of float64 clouds, outside Oxford's test
    region (all train records), one cloud file missing."""
    rng = np.random.RandomState(1)
    for t, trip in enumerate(("2014-11-14-16-34-33", "2014-11-18-13-20-12")):
        cloud_dir = os.path.join(root, "oxford", trip, "pointcloud_20m_10overlap")
        os.makedirs(cloud_dir)
        with open(cloud_dir + ".csv", "w") as f:
            f.write("timestamp,northing,easting\n")
            for i in range(n):
                stamp = 1400000000000000 + 1000 * i + t
                f.write(f"{stamp},{5730000.0 + 4.0 * i + t:.6f},{620000.0 + rng.rand():.6f}\n")
                if (t, i) != (1, 2):
                    (rng.randn(num_points, 3) * 30).tofile(os.path.join(cloud_dir, f"{stamp}.bin"))


def test_scene_native_route_equals_numpy_route_and_jax(tmp_path, monkeypatch):
    _oxford_tree(str(tmp_path))
    monkeypatch.setenv(J.DATA_ROOT_ENV, str(tmp_path))
    scene = P.SceneDataset("oxford", for_training=True, device=CPU)
    scene.create(save=False)
    scene.num_points = 64
    present = [i for i, f in enumerate(scene.records.file) if os.path.exists(f)]
    missing = [i for i, f in enumerate(scene.records.file) if not os.path.exists(f)]
    assert len(present) == 11 and len(missing) == 1
    calls = []
    real = fast_loader.load_clouds
    monkeypatch.setattr(fast_loader, "load_clouds", lambda *a, **k: calls.append(len(a[0])) or real(*a, **k))
    native, _ = scene.get_clouds(present + missing)
    assert calls == [12]
    assert not native[-1].any()                                # the unreadable file: a row of zeros
    plain = P.SceneDataset("oxford", for_training=True, device=CPU)
    plain.native_loader = False
    plain.create(save=False)
    want, _ = plain.get_clouds(present)
    assert calls == [12]
    np.testing.assert_array_equal(native[:-1], want)
    j = J.SceneDataset("oxford", for_training=True)
    j.create(save=False)
    j.num_points = 64
    np.testing.assert_array_equal(native, j.get_clouds(present + missing)[0])
