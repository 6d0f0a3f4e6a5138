"""The port's MinkLoc3Dv2 and its SmoothAP trainer against the JAX package, on the CPU.

The configuration is the JAX suite's ``SPARSE_PARAM``
(``tests/test_minkloc_sparse.py``: planes (16, 32, 16, 8), feature size
64, step 0.05) on 256-point clouds drawn with numpy; the JAX variable
trees come from ``jax.eval_shape`` of the dense model's init (the sparse
tree is the same), every leaf drawn from a numpy generator, carried into
the port with ``load_jax_variables``, whose strict walk must take it
whole.

Exactly equal to the jitted JAX functions:
- the quantized coords, ``valid`` and ``dims``, cartesian at steps 0.05
  and 0.01 and polar, on points at bin edges (``k * step`` as float32)
  and one ulp either side of them;
- every level's table keys and mask, every route ``src`` (conv0, the
  blocks, the down maps), ``up_nbr`` and ``overflow``: at full capacity,
  at the capacities ``suggest_level_capacities`` gives, and at half of
  them (overflowing).

Within a tolerance, each beside the largest difference measured here:
- descriptors, 1e-4 absolute (measured 1.8e-7): the sparse backend with
  every block and pooling, polar coordinates, and the dense backend on a
  cartesian and a polar grid; the
  JAX oracle of the default model is the whole jitted ``apply``, the
  others run the JAX FPN on the JAX pyramid, all with the JAX package's
  im2col convolution (``PCR_SPARSE_CONV=im2col``: its z-run default takes
  4 s longer to compile, and JAX's own suite holds the two equal);
- single modules against flax: the dense conv at k=5, 3, 2 (stride 2)
  and 1, the transposed conv (the torch weight is the flax kernel flipped
  on the three spatial axes), ECA at 32 and 128 channels, train-mode
  ``MaskedBatchNorm``'s output, 1e-5 (measured 2.0e-6, the k=5 conv), and
  its new statistics 2e-5 relative (measured 8.2e-8);
- the port's own dense and sparse FPN on one occupancy with shared
  weights, at the stored sites, 1e-5 (measured 1.9e-6);
- ``truncated_smooth_ap``: loss and stats 5e-5 relative (measured
  1.0e-7), the embeddings' gradient 1e-5 in relative L2 (measured 1.0e-6);
- AdamW and Adam under a MultiStepLR schedule against optax over three
  steps across a milestone, 1e-6 absolute and relative on parameters of
  unit scale (measured 2.4e-7);
- the SmoothAP train step (the two-level cut of the configuration, 8
  clouds, AdamW, the milestone after the first step) against the JAX
  ``build_smoothap_train_step``: each step's stats 5e-5 relative
  (measured 3.9e-6 and 1.3e-5), the new batch statistics 2e-5 relative
  plus 1e-6 absolute (measured 1.2e-7 absolute).

The quantizers match XLA's arithmetic, not exact division: XLA rewrites
``p / step`` into ``p * (1 / step)``. With exact division in the port the
three quantizer tests fail (30, 366 and 18 coordinates of their edge
clouds differ, at steps 0.05, 0.01 and polar). Two
XLA-CPU behaviours are held as divergences (ROADMAP C): it flushes
subnormal inputs to zero, and it fuses polar theta's multiply-add into an
FMA.

The JAX oracles compile with XLA's optimisations and CPU fusion emitters
off (``_jit``), on one torch thread, as ``tests/test_torch_pptnet.py``.
"""
import functools

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu import data as jdata
from patchaugnet_tpu.losses.extra import truncated_smooth_ap as jax_truncated_smooth_ap
from patchaugnet_tpu.models import minkloc3dv2 as jmk
from patchaugnet_tpu.models import minkloc_sparse as jms
from patchaugnet_tpu.models import minkloc_config as jconfig
from patchaugnet_tpu.train import smoothap as jsmoothap
from patchaugnet_tpu.train.state import TrainState as JaxTrainState

from patchaugnet_tpu_torch import configs, data, train
from patchaugnet_tpu_torch.compat import load_jax_variables
from patchaugnet_tpu_torch.losses import truncated_smooth_ap
from patchaugnet_tpu_torch.models import MinkLoc3Dv2, get_model
from patchaugnet_tpu_torch.models import minkloc3dv2 as mk
from patchaugnet_tpu_torch.models import minkloc_config
from patchaugnet_tpu_torch.models import minkloc_sparse as ms
from patchaugnet_tpu_torch.nn import seeded_init_, training_init_

SPARSE_PARAM = {
    "feature_size": 64,
    "output_dim": 64,
    "planes": [16, 32, 16, 8],
    "layers": [1, 1, 1, 1],
    "num_top_down": 2,
    "conv0_kernel_size": 5,
    "block": "ECABasicBlock",
    "pooling": "GeM",
    "coordinates": "cartesian",
    "quantization_step": 0.05,
    "normalize_embeddings": False,
}
# the train step's model: SPARSE_PARAM cut to two levels and one top-down step
STEP_PARAM = dict(SPARSE_PARAM, planes=[16, 32], layers=[1, 1], num_top_down=1)
POLAR_STEPS = (2.0, 0.05, 0.05)
N = 256
DESC_TOL = 1e-4
MODULE_TOL = 1e-5
STATS_RTOL = 2e-5
LOSS_RTOL = 5e-5
GRAD_RTOL = 1e-5
OPT_RTOL = 1e-6           # of parameters of unit scale


def _jit(fn):
    """``jax.jit`` with XLA's CPU fusion emitters off (with the module's
    ``jax_disable_most_optimizations``: quick compiles of the same
    programs)."""
    return jax.jit(fn, compiler_options={"xla_cpu_use_fusion_emitters": False})


@pytest.fixture(autouse=True, scope="module")
def _one_thread_quick_compiles():
    threads = torch.get_num_threads()
    optimise = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimise)
    torch.set_num_threads(threads)


def _random_variables(shapes, rng):
    """A JAX variable tree of ``shapes`` drawn from ``rng``: kernels normal
    with std ``1/sqrt(fan_in)`` (every axis but the last), scales and
    running variances uniform in [0.5, 1.5], biases and running means
    normal (std 0.1 and 0.2), GeM's ``p`` uniform in [2, 4]."""
    def fill(key, leaf):
        shape = tuple(leaf.shape)
        if key in ("scale", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if key in ("bias", "mean"):
            return (rng.randn(*shape) * (0.2 if key == "mean" else 0.1)).astype(np.float32)
        if key == "p":
            return (rng.rand(*shape) * 2 + 2).astype(np.float32)
        fan = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else fill(k, v) for k, v in tree.items()}

    return walk(shapes)


@functools.lru_cache(maxsize=None)
def _tree_shapes(block, pooling, planes, layers, num_top_down):
    dense = jmk.build_minkloc(dict(SPARSE_PARAM, block=block, pooling=pooling, planes=planes, layers=layers,
                                   num_top_down=num_top_down, grid_size=16))
    return _as_dict(jax.eval_shape(dense.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 3))))


def _variables(param, rng):
    """Random variables of the JAX tree of ``param``'s model (the dense
    model's init, the sparse tree being the same; the coordinates and the
    grid change no shape)."""
    return _random_variables(_tree_shapes(param["block"], param["pooling"], tuple(param["planes"]),
                                          tuple(param["layers"]), param["num_top_down"]), rng)


def _clouds(rng, b=2, n=N):
    return rng.rand(b, n, 3).astype(np.float32) * 2 - 1


def _surface_clouds(rng, b=2, n=N):
    """Ground plane + one wall (``tests/test_minkloc_sparse.py``): the
    stride-2 levels merge voxels hard, the regime of ``level_capacity``."""
    out = []
    for _ in range(b):
        n_g = n // 2
        g = np.stack([rng.rand(n_g) * 2 - 1, rng.rand(n_g) * 2 - 1, rng.randn(n_g) * 0.01], axis=-1)
        w = np.stack([rng.rand(n - n_g) * 2 - 1, np.full(n - n_g, 0.3), rng.rand(n - n_g) * 0.8], axis=-1)
        out.append(np.concatenate([g, w], 0).astype(np.float32))
    return np.stack(out)


def _edges(step, k):
    """``j * step`` in float32 for |j| <= k, and one ulp either side."""
    e = np.float32(np.arange(-k, k + 1)) * np.float32(step)
    return np.concatenate([e, np.nextafter(e, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf))])


def _edge_clouds(rng, values):
    """Two clouds whose coordinates run through ``values`` (each value on
    each axis, the other axes random), then random points."""
    v = np.asarray(values, np.float32)
    pts = rng.rand(2, 3 * len(v) + 64, 3).astype(np.float32) * 2 - 1
    for axis in range(3):
        pts[0, axis * len(v):(axis + 1) * len(v), axis] = v
        pts[1, axis * len(v):(axis + 1) * len(v), axis] = v[::-1]
    return pts


def test_get_model_builds_each_backend():
    """``minkloc3dv2`` at its full-width config: the sparse backend at step
    0.01 and full capacity, 225 cells per axis; ``backend: dense`` and a
    ``grid_size`` give the dense one (48 under the default cap); bf16
    builds the same parameters, f32, its trunk at bf16."""
    model = get_model("minkloc3dv2", configs.MINKLOC3DV2)
    assert isinstance(model, MinkLoc3Dv2) and model.backend == "sparse" and model.level_capacity is None
    assert model.quantization_step == 0.01
    assert model.quantize(torch.zeros(1, 1, 3))[2] == (225, 225, 225)
    dense = get_model("minkloc3dv2", dict(configs.MINKLOC3DV2, backend="dense"))
    assert dense.backend == "dense" and dense.grid_dims == (48, 48, 48)
    assert get_model("minkloc3dv2", dict(configs.MINKLOC3DV2, grid_size=32)).grid_dims == (32, 32, 32)
    assert [n for n, _ in dense.named_parameters()] == [n for n, _ in model.named_parameters()]
    bf16 = get_model("minkloc3dv2", dict(configs.MINKLOC3DV2, COMPUTE_DTYPE="bfloat16"))
    assert bf16.backbone.compute_dtype is torch.bfloat16 and model.backbone.compute_dtype is None
    assert [(n, p.dtype) for n, p in bf16.named_parameters()] == [(n, p.dtype) for n, p in model.named_parameters()]


def test_initialisers_fill_minkloc():
    """``seeded_init_``: every conv kernel normal with std
    ``1/sqrt(k^3 Cin)``, ECA's over its k taps, GeM's ``p`` 3;
    ``training_init_`` keeps those and resets the BatchNorms."""
    model = seeded_init_(get_model("minkloc3dv2", SPARSE_PARAM), torch.Generator().manual_seed(0))
    conv = model.backbone.block1_0.conv2.conv.kernel                   # (3, 3, 3, 32, 32)
    assert abs(conv.std().item() * (27 * 32) ** 0.5 - 1) < 0.05
    assert model.backbone.block1_0.eca.conv.kernel.shape == (3, 1, 1)
    assert model.pooling.p.item() == 3.0
    fresh = training_init_(get_model("minkloc3dv2", SPARSE_PARAM), torch.Generator().manual_seed(0))
    assert torch.equal(fresh.backbone.conv0.conv.kernel, model.backbone.conv0.conv.kernel)
    assert torch.equal(fresh.backbone.conv0.bn.running_var, torch.ones(16)) and fresh.pooling.p.item() == 3.0


def test_ini_configs_parse_as_jax(tmp_path):
    model_ini, train_ini = tmp_path / "model.txt", tmp_path / "train.txt"
    model_ini.write_text("[MODEL]\nmodel=MinkLoc\nplanes=64,128,64,32\nlayers=1,1,1,1\nnum_top_down=2\n"
                         "conv0_kernel_size=5\nfeature_size=256\nblock=ECABasicBlock\npooling=GeM\n"
                         "coordinates=polar\nquantization_step=2,0.05,0.05\nlevel_capacity=4096,3584,2560,1280,512\n")
    train_ini.write_text("[DEFAULT]\ndataset_folder=/tmp\n[TRAIN]\nbatch_size=2048\nbatch_split_size=64\n"
                         "batch_expansion_th=0.7\nlr=1e-3\nepochs=400\nscheduler_milestones=250, 350\n"
                         "weight_decay=1e-4\nloss=TruncatedSmoothAP\ntau1=0.01\npositives_per_query=4\n")
    got = minkloc_config.TrainingParams.from_ini(str(train_ini), str(model_ini))
    want = jconfig.TrainingParams.from_ini(str(train_ini), str(model_ini))
    assert got.__dict__.keys() == want.__dict__.keys()
    for key, value in want.__dict__.items():
        if key != "model_params":
            assert getattr(got, key) == value, key
    assert got.model_params.as_dict() == want.model_params.as_dict()
    assert got.model_params.quantization_step == POLAR_STEPS


@pytest.mark.parametrize("coordinates, step", [("cartesian", 0.05), ("cartesian", 0.01), ("polar", POLAR_STEPS)])
def test_quantizers_match_jitted_jax(coordinates, step):
    """Coords, ``valid`` and ``dims`` exactly equal on bin-edge points (for
    polar: rings and z on their edges, theta 0 and 180 degrees)."""
    rng = np.random.RandomState(1)
    if coordinates == "cartesian":
        pts = _edge_clouds(rng, _edges(step, int(round(1.8 / step))))
        fn = lambda p: jms.quantize_cartesian(p, step)
        port = ms.quantize_cartesian(torch.from_numpy(pts), step)
    else:
        ring = _edges(step[1], 40)
        pts = _edge_clouds(rng, ring)
        pts[0, :len(ring), 1] = 0.0                              # theta on its 0 / 180 degree edges
        fn = lambda p: jms.quantize_polar(p, step)
        port = ms.quantize_polar(torch.from_numpy(pts), step)
    coords, valid = _jit(lambda p: fn(p)[:2])(jnp.asarray(pts))
    coords = np.array(coords)
    # XLA on the CPU flushes subnormal inputs to zero (ROADMAP C): a
    # coordinate one ulp below 0 floors to 0 there and to -1 in the port,
    # as numpy's product and floor give it
    flushed = (pts < 0) & (pts > -np.finfo(np.float32).tiny)
    if coordinates == "polar":
        flushed[..., :2] = False        # theta and ring: no flush shows in atan2 and the norm
    assert flushed.sum() == (6 if coordinates == "cartesian" else 2)
    coords[flushed] -= 1
    valid = np.array(valid)
    if coordinates == "polar":
        # and it fuses theta's 180 + atan2 * (180 / pi) into one FMA (ROADMAP
        # C): at atan2 = -pi (y = -0, x < 0) theta is -7.1e-6 there, out of
        # the grid, and 0.0 in the port (the product rounded first)
        minus_pi = (pts[..., 0] < 0) & np.signbit(pts[..., 1]) & (pts[..., 1] > -np.finfo(np.float32).tiny)
        assert minus_pi.sum() == 1 and not valid[minus_pi].any()
        valid[minus_pi] = True
    np.testing.assert_array_equal(coords, port[0].numpy())
    np.testing.assert_array_equal(valid, port[1].numpy())
    assert port[2] == fn(jnp.zeros((1, 1, 3)))[2]
    assert port[0].dtype == torch.int32 and not port[1].all() and port[1].any()


def _jax_pyramid(coords, valid, dims, caps=None, levels=4, top_down=2):
    return _jit(lambda c, v: jms.build_pyramid(c, v, dims, levels, top_down, 5, level_capacity=caps))(coords, valid)


@pytest.fixture(scope="module")
def cartesian_case():
    """Random clouds, their JAX coords and full-capacity JAX pyramid."""
    clouds = _clouds(np.random.RandomState(2))
    coords, valid, dims = jms.quantize_cartesian(jnp.asarray(clouds), SPARSE_PARAM["quantization_step"])
    coords, valid = _jit(lambda p: jms.quantize_cartesian(p, SPARSE_PARAM["quantization_step"])[:2])(
        jnp.asarray(clouds))
    return clouds, dims, _jax_pyramid(coords, valid, dims)


def _assert_pyramids_equal(want, got, levels=4):
    assert len(want.tables) == len(got.tables) == levels + 1 and want.dims == got.dims
    for level, (w, g) in enumerate(zip(want.tables, got.tables)):
        np.testing.assert_array_equal(np.asarray(w.keys), g.keys.numpy(), err_msg=f"keys {level}")
        np.testing.assert_array_equal(np.asarray(w.mask), g.mask.numpy(), err_msg=f"mask {level}")
    routes = [("conv0", want.conv0_routes, got.conv0_routes)]
    routes += [(f"block {i}", w, g) for i, (w, g) in enumerate(zip(want.block_routes, got.block_routes))]
    routes += [(f"down {i}", w, g) for i, (w, g) in enumerate(zip(want.down_routes, got.down_routes))]
    assert len(routes) == 2 * levels + 1
    for name, w, g in routes:
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w.src), g.numpy(), err_msg=name)
    assert len(want.up_nbr) == len(got.up_nbr) == min(levels - 1, 2)
    for (wi, wv), (gi, gv) in zip(want.up_nbr, got.up_nbr):
        np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
        np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    assert int(want.overflow) == int(got.overflow)


def test_pyramid_matches_jax_at_full_capacity(cartesian_case):
    clouds, dims, want = cartesian_case
    model = get_model("minkloc3dv2", SPARSE_PARAM)
    got = model.pyramid(torch.from_numpy(clouds))
    _assert_pyramids_equal(want, got)
    assert got.conv0_routes.shape == (2, N, 125) and int(got.overflow) == 0
    # absent neighbours, present ones, and a coarse level mostly padding
    assert (got.conv0_routes == N).any() and (got.conv0_routes < N).any() and got.tables[4].mask.float().mean() < 0.5


@pytest.mark.parametrize("fit", [True, False], ids=["fitting", "overflowing"])
def test_pyramid_matches_jax_at_level_capacities(fit):
    """Surface clouds: the occupancy counts equal JAX's; the tables at the
    capacities ``suggest_level_capacities`` gives (all fit) or at half the
    counts (the highest keys drop, ``overflow`` > 0, their children's
    transposed-conv slot invalid). Two levels (a shorter JAX compile)."""
    clouds = _surface_clouds(np.random.RandomState(3))
    step = SPARSE_PARAM["quantization_step"]
    counts = ms.measure_level_occupancy(clouds, num_levels=4, quantization_step=step)
    np.testing.assert_array_equal(counts, jms.measure_level_occupancy(clouds, num_levels=4, quantization_step=step))
    if fit:
        caps = ms.suggest_level_capacities(counts, margin=1.1, align=8, full=N)
        assert caps == jms.suggest_level_capacities(counts, margin=1.1, align=8, full=N) and caps[-1] < N
    else:
        caps = [max(int(counts[:, i].max()) // 2, 8) for i in range(5)]
    caps = caps[:3]
    coords, valid = _jit(lambda p: jms.quantize_cartesian(p, step)[:2])(jnp.asarray(clouds))
    dims = jms.quantize_cartesian(jnp.zeros((1, 1, 3)), step)[2]
    want = _jax_pyramid(coords, valid, dims, caps, levels=2, top_down=1)
    pcoords, pvalid, _ = ms.quantize_cartesian(torch.from_numpy(clouds), step)
    got = ms.build_pyramid(pcoords, pvalid, dims, num_levels=2, num_top_down=1, conv0_kernel_size=5,
                           level_capacity=caps)
    _assert_pyramids_equal(want, got, levels=2)
    assert [t.keys.shape[1] for t in got.tables] == caps
    assert (int(got.overflow) > 0) == (not fit)


def _jax_sparse_descriptor(param, variables, pyramid):
    """The JAX sparse model's body (``MinkLocSparse.__call__``) on a JAX
    pyramid: the FPN from the occupancy, the pooling."""
    jmodel = jmk.build_minkloc(param)
    fpn = jms.SparseVoxelFPN(out_channels=jmodel.feature_size, planes=jmodel.planes, layers=jmodel.layers,
                             num_top_down=jmodel.num_top_down, conv0_kernel_size=jmodel.conv0_kernel_size,
                             block=jmodel.block)
    pool = jmk.MaskedPooling(jmodel.pooling, jmodel.feature_size, jmodel.output_dim)

    def apply(v, pyr):
        x, mask = fpn.apply({"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]},
                            None, pyr)
        pooled = {k: v[k]["pooling"] for k in v if "pooling" in v[k]}
        return pool.apply(pooled, x, mask)

    return np.asarray(_jit(apply)(variables, pyramid))


@pytest.mark.parametrize("block, pooling, coordinates", [
    ("ECABasicBlock", "GeM", "cartesian"),
    ("BasicBlock", "MAC", "cartesian"),
    ("Bottleneck", "SPoC", "cartesian"),
    ("ECABasicBlock", "netvlad", "cartesian"),
    ("BasicBlock", "netvladgc", "cartesian"),
    ("ECABasicBlock", "GeM", "polar"),
])
def test_sparse_descriptors_match_jax(cartesian_case, monkeypatch, block, pooling, coordinates):
    """Eval descriptors on carried weights within DESC_TOL. The default
    model against the whole jitted JAX ``apply``, the rest against its FPN
    on the JAX pyramid; both with the JAX package's im2col convolution."""
    clouds, dims, pyramid = cartesian_case
    param = dict(SPARSE_PARAM, block=block, pooling=pooling, coordinates=coordinates)
    if coordinates == "polar":
        param["quantization_step"] = POLAR_STEPS
    variables = _variables(param, np.random.RandomState(4))
    monkeypatch.setenv("PCR_SPARSE_CONV", "im2col")
    if (block, pooling) == ("ECABasicBlock", "GeM") and coordinates == "cartesian":
        jmodel = jmk.build_minkloc(param)
        want = np.asarray(_jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(clouds)))
    else:
        if coordinates == "polar":
            coords, valid = _jit(lambda p: jms.quantize_polar(p, POLAR_STEPS)[:2])(jnp.asarray(clouds))
            pyramid = _jax_pyramid(coords, valid, jms.quantize_polar(jnp.zeros((1, 1, 3)), POLAR_STEPS)[2])
        want = _jax_sparse_descriptor(param, variables, pyramid)
    model = load_jax_variables(get_model("minkloc3dv2", param), variables).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(clouds))
    assert got.shape == (2, 64) and model.backend == "sparse"
    np.testing.assert_allclose(got.numpy(), want, atol=DESC_TOL)


@pytest.mark.parametrize("coordinates", ["cartesian", "polar"])
def test_dense_descriptors_match_jax(coordinates):
    """The dense backend (a 16^3 grid, or the (64, 32, 16) polar grid) on
    carried weights, and the ``return_diagnostics`` of the sparse one at
    full capacity."""
    clouds = _clouds(np.random.RandomState(5))
    param = dict(SPARSE_PARAM, grid_size=16, coordinates=coordinates)
    variables = _variables(param, np.random.RandomState(6))
    jmodel = jmk.build_minkloc(param)
    want = np.asarray(_jit(lambda v, x: jmodel.apply(v, x))(variables, jnp.asarray(clouds)))
    model = load_jax_variables(get_model("minkloc3dv2", param), variables).eval()
    assert model.backend == "dense" and model.grid_dims == ((16,) * 3 if coordinates == "cartesian" else (64, 32, 16))
    with torch.inference_mode():
        np.testing.assert_allclose(model(torch.from_numpy(clouds)).numpy(), want, atol=DESC_TOL)
        sparse = load_jax_variables(get_model("minkloc3dv2", SPARSE_PARAM), variables).eval()
        out, diag = sparse(torch.from_numpy(clouds), return_diagnostics=True)
    assert out.shape == (2, 64) and int(diag["capacity_overflow"]) == 0


def _occupancy_case(rng, g=8, n_cap=256, fill=0.3, b=2):
    """A random occupancy grid and its cells as padded coords (the JAX
    suite's ``_make_case``)."""
    occ = rng.rand(b, g, g, g) < fill
    coords = np.zeros((b, n_cap, 3), np.int32)
    valid = np.zeros((b, n_cap), bool)
    for bi in range(b):
        cells = np.argwhere(occ[bi])
        coords[bi, :len(cells)] = cells
        valid[bi, :len(cells)] = True
    grid = torch.from_numpy(occ[..., None].astype(np.float32))
    return grid, torch.from_numpy(occ), torch.from_numpy(coords), torch.from_numpy(valid), (g, g, g)


@pytest.mark.parametrize("block", ["BasicBlock", "ECABasicBlock", "Bottleneck"])
def test_dense_and_sparse_fpn_agree(block):
    """The port's FPN on a dense grid and on the voxel tables of the same
    occupancy, one set of weights, in train mode (batch statistics) and in
    eval mode: equal at the stored sites within MODULE_TOL, as
    ``test_fpn_bitmatch_with_shared_params`` asserts for JAX."""
    grid, occ, coords, valid, dims = _occupancy_case(np.random.RandomState(7))
    fpn = mk.MinkFPN(8, planes=(8, 16), layers=(1, 1), num_top_down=1, block=block)
    seeded_init_(fpn, torch.Generator().manual_seed(1))
    twin = mk.MinkFPN(8, planes=(8, 16), layers=(1, 1), num_top_down=1, block=block)
    twin.load_state_dict(fpn.state_dict())
    pyramid = ms.build_pyramid(coords, valid, dims, num_levels=2, num_top_down=1, conv0_kernel_size=5)
    for train_mode in (True, False):
        fpn.train(train_mode)
        twin.train(train_mode)
        yd, dmask = fpn(grid, mk.dense_masks(occ, 2))
        ys, smask = twin(None, [t.mask for t in pyramid.tables], pyramid)
        keys, tmask = pyramid.tables[1].keys, pyramid.tables[1].mask
        for bi in range(2):
            cells = ms.decompose_keys(keys[bi, tmask[bi]], pyramid.dims[1]).long()
            assert dmask[bi][tuple(cells.T)].all() and int(dmask[bi].sum()) == int(tmask[bi].sum())
            np.testing.assert_allclose(yd[bi][tuple(cells.T)].detach().numpy(), ys[bi, tmask[bi]].detach().numpy(),
                                       atol=MODULE_TOL)
    for a, b in zip(fpn.buffers(), twin.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=MODULE_TOL)


def _dense_grid(rng, b=2, g=8, c=4):
    return rng.randn(b, g, g, g, c).astype(np.float32)


@pytest.mark.parametrize("kind", ["conv5", "conv3", "down2", "lateral1", "tconv", "eca32", "eca128", "masked_bn"])
def test_modules_match_flax(kind):
    """The dense conv against flax ``nn.Conv`` (SAME), the transposed conv
    against ``nn.ConvTranspose`` (torch's weight is the flax kernel
    flipped), ECA and train-mode ``MaskedBatchNorm`` (output, new
    statistics) against the JAX modules, each on the same kernel."""
    from flax import linen as fnn

    rng = np.random.RandomState(8)
    x = _dense_grid(rng)
    mask = rng.rand(*x.shape[:4]) < 0.4
    if kind.startswith("eca"):
        c = int(kind[3:])
        x = _dense_grid(rng, c=c)
        jmod, mod = jmk.ECALayer(c), mk.ECALayer(c)
        args = (x, mask)
    elif kind == "masked_bn":
        jmod, mod = jmk.MaskedBatchNorm(), mk.MaskedBatchNorm(4).train()
        args = (x, mask)
    elif kind == "tconv":
        jmod = fnn.ConvTranspose(5, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
        mod, args = mk.VoxelTConv(4, 5), (x,)
    else:
        k, s = {"conv5": (5, 1), "conv3": (3, 1), "down2": (2, 2), "lateral1": (1, 1)}[kind]
        jmod = fnn.Conv(5, (k,) * 3, strides=(s,) * 3, padding="SAME", use_bias=False)
        mod, args = mk.VoxelConv(4, 5, k, s), (x,)
    kwargs = {"use_running_average": False} if kind == "masked_bn" else {}
    variables = _random_variables(_as_dict(jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, **kwargs),
                                                          *args)), rng)
    load_jax_variables(mod, variables)
    want, new_vars = _jit(lambda v, *a: jmod.apply(v, *a, mutable=["batch_stats"], **kwargs))(variables, *args)
    got = mod(*[torch.from_numpy(np.asarray(a)) for a in args])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MODULE_TOL)
    if kind == "masked_bn":
        stats = new_vars["batch_stats"]
        np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(stats["mean"]), rtol=STATS_RTOL, atol=1e-7)
        np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(stats["var"]), rtol=STATS_RTOL)


def _as_dict(tree):
    return {k: _as_dict(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


def _smoothap_masks(rng, b):
    """Pair-expanded masks: 2i and 2i+1 positives of each other, a few more
    positives (row 0 has five, more than ``positives_per_query``), a few
    rows in the unknown ring, the rest negatives."""
    pos = np.zeros((b, b), bool)
    for i in range(0, b, 2):
        pos[i, i + 1] = pos[i + 1, i] = True
    pos[0, 2:6] = True
    eye = np.eye(b, dtype=bool)
    neg = ~pos & ~eye & (rng.rand(b, b) < 0.8)
    return pos, neg


def test_truncated_smooth_ap_matches_jax():
    """Loss and stats within LOSS_RTOL, the gradient in relative L2 within
    GRAD_RTOL, on 12 embeddings: two of them equal (tied similarities), a
    row with five positives, one with one (it picks among the fills) and
    one with none."""
    rng = np.random.RandomState(9)
    emb = rng.randn(12, 16).astype(np.float32)
    emb[5] = emb[4]
    pos, neg = _smoothap_masks(rng, 12)
    pos[11] = False
    pos[:, 11] = False
    neg[11, :3] = True
    loss_fn = lambda e: jax_truncated_smooth_ap(e, pos, neg)
    (want, wstats), wgrad = _jit(jax.value_and_grad(loss_fn, has_aux=True))(jnp.asarray(emb))
    x = torch.from_numpy(emb).requires_grad_()
    got, stats = truncated_smooth_ap(x, torch.from_numpy(pos), torch.from_numpy(neg))
    got.backward()
    assert set(stats) == set(wstats)
    for key, value in wstats.items():
        np.testing.assert_allclose(stats[key].item(), float(value), rtol=LOSS_RTOL, err_msg=key)
    g = x.grad.numpy()
    assert np.linalg.norm(g - np.asarray(wgrad)) <= GRAD_RTOL * np.linalg.norm(np.asarray(wgrad))
    assert 0 < float(want) < 1


@pytest.mark.parametrize("weight_decay", [0.5, None], ids=["adamw", "adam"])
def test_optimizer_matches_optax(weight_decay):
    """``smoothap_optimizer`` (torch AdamW, or Adam without a decay) under
    ``multistep_schedule`` against optax's ``adamw`` / ``adam`` under the
    JAX ``multistep_schedule``: three updates, the milestone after the
    second; every parameter decays."""
    rng = np.random.RandomState(10)
    params = {"w": rng.randn(5, 3).astype(np.float32), "p": np.full((1,), 3.0, np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    jsched = jsmoothap.multistep_schedule(1e-2, [2], steps_per_epoch=1)
    tx = optax.adamw(jsched, weight_decay=weight_decay) if weight_decay else optax.adam(jsched)

    def run(jparams, grads):
        opt_state = tx.init(jparams)
        for g in grads:
            updates, opt_state = tx.update(g, opt_state, jparams)
            jparams = optax.apply_updates(jparams, updates)
        return jparams

    jparams = _jit(run)(params, grads)

    holder = torch.nn.Module()
    for k, v in params.items():
        holder.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    sched = train.multistep_schedule(1e-2, [2], steps_per_epoch=1)
    assert [sched(c) for c in range(4)] == pytest.approx(np.asarray(_jit(lambda: jnp.stack(
        [jsched(c) for c in range(4)]))()).tolist(), rel=1e-6)
    tx = train.smoothap_optimizer(sched, weight_decay)
    state = train.TrainState(model=holder, optimizer=tx.make(holder.parameters(), sched(0)), schedule=sched)
    assert isinstance(state.optimizer, torch.optim.AdamW if weight_decay else torch.optim.Adam)
    for g in grads:
        for k, p in holder.named_parameters():
            p.grad = torch.from_numpy(g[k])
        state.apply_gradients()
    for k, p in holder.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=OPT_RTOL, atol=OPT_RTOL, err_msg=k)


def test_smoothap_step_matches_jax(monkeypatch):
    """Two steps of the SmoothAP trainer (the two-level cut of the
    configuration: a JAX trace and compile of about 5 s instead of 9) on 8 clouds, AdamW at 1e-3 with
    a decay of 1e-4 and the learning rate cut tenfold after the first step,
    against the JAX ``build_smoothap_train_step`` on the same weights: each
    step's stats within LOSS_RTOL, the new batch statistics after the
    first within STATS_RTOL (plus 1e-6 absolute)."""
    monkeypatch.setenv("PCR_SPARSE_CONV", "im2col")
    param = STEP_PARAM
    rng = np.random.RandomState(11)
    clouds = _clouds(rng, b=8)
    pos, neg = _smoothap_masks(rng, 8)
    variables = _variables(param, rng)
    jmodel = jmk.build_minkloc(param)
    jstep, tx = jsmoothap.build_smoothap_train_step(jmodel, jsmoothap.multistep_schedule(1e-3, [1], 1),
                                                     weight_decay=1e-4)
    jstep = _jit(jstep.__wrapped__)          # the same step, compiled as the other oracles
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=_jit(tx.init)(params), tx=tx)
    jstate, want1 = jstep(jstate, jnp.asarray(clouds), jnp.asarray(pos), jnp.asarray(neg))
    new_stats = jax.tree.map(np.asarray, jstate.batch_stats)
    jstate, want2 = jstep(jstate, jnp.asarray(clouds), jnp.asarray(pos), jnp.asarray(neg))

    model = load_jax_variables(get_model("minkloc3dv2", param), variables)
    step, ptx = train.build_smoothap_train_step(model, train.multistep_schedule(1e-3, [1], 1), weight_decay=1e-4)
    state = train.create_train_state(model, {}, device="cpu", tx=ptx)
    expected = load_jax_variables(get_model("minkloc3dv2", param),
                                  {"params": variables["params"], "batch_stats": _as_dict(new_stats)})
    for want in (want1, want2):
        state, got = step(state, clouds, pos, neg)
        for key, value in want.items():
            np.testing.assert_allclose(got[key].item(), float(value), rtol=LOSS_RTOL, err_msg=key)
        if want is want1:
            for (name, a), b in zip(state.model.named_buffers(), expected.buffers()):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STATS_RTOL, atol=1e-6, err_msg=name)
    assert state.step == 2 and state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)


def test_smoothap_batches_match_jax():
    """``sample_smoothap_batch`` and ``build_masks`` on the synthetic scene
    equal the JAX package's from the same ``random.Random`` seed."""
    import random

    kw = dict(num_pos=2, num_neg=4, num_points=32, seed=3)
    jscene = jdata.PlaceRecognitionDataset("synthetic", True, **kw).scene
    scene = data.PlaceRecognitionDataset("synthetic", True, device="cpu", **kw).scene
    jrng, rng = random.Random(5), random.Random(5)
    for _ in range(3):
        want = jsmoothap.sample_smoothap_batch(jscene, 16, jrng)
        got = train.sample_smoothap_batch(scene, 16, rng)
        assert got == want and len(got) == 16
        for a, b in zip(train.build_masks(scene, got), jsmoothap.build_masks(jscene, want)):
            np.testing.assert_array_equal(a, b)
    assert train.sample_smoothap_batch(scene, 2 * len(scene.records) + 2, rng) is None
