"""The port's reference-checkpoint import against the JAX package's, on the CPU.

For each model type the JAX package imports (``patch_aug_net``, ``pptnet``,
``pptnet_l2_norm``, ``pointnet_vlad``, ``minkloc3dv2``), at tiny widths: a
JAX variable tree of the model's shapes (PatchAugNet's with its patch
decoder, as ``evaluate.py`` inits it) is drawn from a numpy generator, BatchNorm statistics included, and written as a
reference ``.pth`` by the port's ``compat.reference_state_dict`` (the
reference's keys and layouts: the inverse of the JAX converter's
transforms), wrapped in ``state_dict_encoder`` and bare. The JAX
package's ``load_torch_checkpoint`` is the oracle for that file: it must
take every key and give back exactly the drawn tree, and the keys must
have the reference modules' shapes (4-d ``Conv2d`` weights, 3-d ``Conv1d``
ones, ``(K^3, Cin, Cout)`` ME kernels). The same file then goes through
the port's ``load_torch_checkpoint`` into the port's model, whose
parameters must equal the drawn tree, and the port's eval forward must
match the JAX forward on the JAX loader's tree: provenance indices (and
MinkLoc's coords and routes) exactly equal, descriptors within 1e-4.

A missing key and a shape that does not fit raise, naming the reference key.

The JAX oracles compile with XLA's optimisations and CPU fusion emitters
off, on one torch thread, as ``tests/test_torch_pptnet.py``; MinkLoc's
with the JAX package's im2col convolution, as ``tests/test_torch_minkloc.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from patchaugnet_tpu.compat import load_torch_checkpoint as jax_load_torch_checkpoint
from patchaugnet_tpu.compat.torch_loader import _CONVERTERS as JAX_CONVERTERS
from patchaugnet_tpu.models import get_model as jax_get_model
from patchaugnet_tpu.models import minkloc_sparse as jms
from patchaugnet_tpu.nn.core import l2_normalize as jax_l2_normalize

from patchaugnet_tpu_torch import configs
from patchaugnet_tpu_torch.compat import load_torch_checkpoint, reference_state_dict, to_jax_variables
from patchaugnet_tpu_torch.compat.torch_loader import read_state_dict
from patchaugnet_tpu_torch.models import get_model

N = 128
DESC_TOL = 1e-4
CFGS = {
    "patch_aug_net": dict(configs.PATCH_AUG_NET, NUM_POINTS=N, SAMPLING=[32, 8, 4], KNN=[8, 8, 4],
                          FEATURE_SIZE=[32] * 3, OUTPUT_DIM=[32] * 3, CLUSTER_SIZE=[1, 2, 4], GATING=True),
    "pptnet": dict(configs.PPTNET_ORIGIN, NUM_POINTS=N, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4],
                   FEATURE_SIZE=[32] * 4, OUTPUT_DIM=[32] * 4, CLUSTER_SIZE=[1, 2, 4, 8], MAX_SAMPLES=[8, 16, 32, 128]),
    "pointnet_vlad": dict(configs.POINTNET_VLAD, NUM_POINTS=N),
    # two levels and one top-down step: the JAX sparse forward compiles in a third of the four levels' time
    "minkloc3dv2": dict(configs.MINKLOC3DV2, planes=[16, 32], layers=[1, 1], num_top_down=1, feature_size=32,
                        output_dim=32, quantization_step=0.05),
}
CFGS["pptnet_l2_norm"] = CFGS["pptnet"]
MODEL_TYPES = ("patch_aug_net", "pptnet", "pptnet_l2_norm", "pointnet_vlad", "minkloc3dv2")
# the reference modules' weight ranks at keys of each family (Conv2d 4-d,
# Conv1d 3-d, Linear 2-d, ME kernels (K^3, Cin, Cout))
REFERENCE_RANKS = {
    "patch_aug_net": {"backbone.SA_modules.0.mlps.0.layer0.conv.weight": 4,
                      "aggregation.afa.mlpa.mlps.0.weight": 3, "aggregation.afa.fc.weight": 2,
                      "decoder.fc1.weight": 2},
    "pptnet": {"backbone.SA_modules.0.sas.0.q_conv.weight": 3, "backbone.SA_modules.0.sas.0.k_conv.weight": 3,
               "backbone.FP_modules.0.mlp.layer0.conv.weight": 4},
    "pointnet_vlad": {"point_net.stn.conv1.weight": 4, "point_net.feature_trans.conv1.weight": 4,
                      "point_net.conv5.weight": 4, "point_net.stn.fc3.weight": 2},
    "minkloc3dv2": {"backbone.conv0.kernel": 3, "backbone.tconvs.0.kernel": 3, "backbone.conv1x1.0.kernel": 2,
                    "backbone.blocks.0.0.eca.conv.weight": 3},
}


def _jit(fn):
    """``jax.jit`` with XLA's CPU fusion emitters off (quick compiles of the
    same programs, with the module's ``jax_disable_most_optimizations``)."""
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


def _as_dict(tree):
    return {k: _as_dict(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


def _random_variables(shapes, rng):
    """Kernels normal with std ``1/sqrt(fan_in)``, scales and running
    variances uniform in [0.5, 1.5], biases and running means normal (std
    0.1 and 0.2), GeM's ``p`` uniform in [2, 4]."""
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

    return {k: _random_variables(v, rng) if isinstance(v, dict) else fill(k, v) for k, v in shapes.items()}


def _assert_trees_equal(want, got, path=""):
    assert set(want) == set(got), (path, sorted(set(want) ^ set(got)))
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(want[key], got[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(want[key]), np.asarray(got[key]), err_msg=f"{path}/{key}")


def _save(path, sd, wrapped):
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"epoch": 3, "iter": 0, "optimizer": {}, "state_dict_encoder": tensors} if wrapped else tensors, path)
    return str(path)


_CASES = {}


def _case(model_type, tmp_path_factory):
    """A dict of the case's cfg, clouds, drawn variables, wrapped and bare
    .pth paths and JAX model (and, once computed, its JAX outputs), shared
    by ``pptnet`` and ``pptnet_l2_norm``. The variables' shapes are the
    port model's tree, which the strict walk of ``load_jax_variables`` holds
    equal to the JAX model's (``tests/test_torch_{patch_aug_net,pptnet,
    pointnet_vlad,minkloc}.py``); it saves a trace of each JAX init."""
    key = "pptnet" if model_type == "pptnet_l2_norm" else model_type
    if key not in _CASES:
        cfg = CFGS[key]
        rng = np.random.RandomState(sum(map(ord, key)))
        clouds = rng.rand(2, N, 3).astype(np.float32)
        if key == "minkloc3dv2":
            clouds = clouds * 2 - 1
        variables = _random_variables(to_jax_variables(get_model(key, cfg)), rng)
        sd = reference_state_dict(key, variables, cfg)
        tmp = tmp_path_factory.mktemp(key)
        paths = {wrapped: _save(tmp / f"{wrapped}.pth", sd, wrapped == "wrapped") for wrapped in ("wrapped", "bare")}
        _CASES[key] = dict(cfg=cfg, clouds=clouds, variables=variables, paths=paths, jm=jax_get_model(key, cfg))
    return _CASES[key]


def _jax_outputs(model_type, case, monkeypatch):
    """The JAX eval forward on the drawn variables: PatchAugNet's and
    PPT-Net's output tuple, the other models' descriptors (MinkLoc's with
    the im2col convolution); ``pptnet_l2_norm``'s is ``pptnet``'s with the
    descriptor normalised (one compile for the two)."""
    if "jax" not in case:
        monkeypatch.setenv("PCR_SPARSE_CONV", "im2col")
        jm = case["jm"]
        case["jax"] = _jit(lambda v, x: jm.apply(v, x, train=False))(case["variables"], jnp.asarray(case["clouds"]))
    out = case["jax"]
    if model_type == "pptnet_l2_norm":
        out = out._replace(global_desc=jax_l2_normalize(out.global_desc, axis=-1))
    return out


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_checkpoint_matches_jax_loader(model_type, tmp_path_factory, monkeypatch):
    case = _case(model_type, tmp_path_factory)
    cfg, clouds, variables, paths = case["cfg"], case["clouds"], case["variables"], case["paths"]
    assert model_type in JAX_CONVERTERS
    sd = read_state_dict(paths["wrapped"])
    for key, rank in REFERENCE_RANKS["pptnet" if model_type == "pptnet_l2_norm" else model_type].items():
        assert sd[key].ndim == rank, key
    models = {}
    for wrapped, path in paths.items():
        # the oracle reads the file back into exactly the drawn tree
        _assert_trees_equal(variables, jax_load_torch_checkpoint(path, model_type, cfg, variables))
        models[wrapped] = load_torch_checkpoint(path, model_type, cfg, get_model(model_type, cfg))
        _assert_trees_equal(variables, to_jax_variables(models[wrapped]))
    model = models["wrapped"].eval()
    want = _jax_outputs(model_type, case, monkeypatch)
    with torch.inference_mode():
        got = model(torch.from_numpy(clouds))
    if model_type in ("pointnet_vlad", "minkloc3dv2"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DESC_TOL)
    else:
        for name in ("center_idx_origin",) + (("sample_idx_origin",) if model_type == "patch_aug_net" else ()):
            for w, g in zip(getattr(want, name), getattr(got, name), strict=True):
                np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
        np.testing.assert_allclose(got.global_desc.numpy(), np.asarray(want.global_desc), atol=DESC_TOL)
    if model_type == "minkloc3dv2":
        step, levels, top_down = cfg["quantization_step"], len(cfg["layers"]), cfg["num_top_down"]
        dims = jms.quantize_cartesian(jnp.zeros((1, 1, 3)), step)[2]

        def pyramid_of(points):
            coords, valid, _ = jms.quantize_cartesian(points, step)
            return coords, jms.build_pyramid(coords, valid, dims, levels, top_down, cfg["conv0_kernel_size"])

        coords, pyramid = _jit(pyramid_of)(jnp.asarray(clouds))
        mine = model.pyramid(torch.from_numpy(clouds))
        np.testing.assert_array_equal(np.asarray(coords), model.quantize(torch.from_numpy(clouds))[0].numpy())
        routes = [(pyramid.conv0_routes, mine.conv0_routes)] + list(zip(pyramid.block_routes, mine.block_routes))
        routes += list(zip(pyramid.down_routes, mine.down_routes, strict=True))
        for w, g in routes:
            np.testing.assert_array_equal(np.asarray(w.src), g.numpy())


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_checkpoint_faults_name_the_key(fault, tmp_path_factory):
    """A key the converter needs that the file lacks raises ``KeyError``; a
    weight of another shape raises ``ValueError``; each names the key."""
    case = _case("patch_aug_net", tmp_path_factory)
    cfg = case["cfg"]
    sd = reference_state_dict("patch_aug_net", case["variables"], cfg)
    key = "backbone.SA_modules.1.mlps.0.layer2.bn.bn.running_var"
    if fault == "missing":
        del sd[key]
    else:
        sd[key] = np.ones(sd[key].shape[0] + 1, np.float32)
    path = _save(tmp_path_factory.mktemp("fault") / "bad.pth", sd, True)
    with pytest.raises(KeyError if fault == "missing" else ValueError, match=key.replace(".", r"\.")):
        load_torch_checkpoint(path, "patch_aug_net", cfg, get_model("patch_aug_net", cfg))


def test_checkpoint_is_read_weights_only(tmp_path_factory):
    """The port reads a checkpoint with ``weights_only=True`` (the JAX
    loader with ``False``, ROADMAP C): a file that pickles an arbitrary
    object beside the weights is refused, not unpickled."""
    import argparse
    import pickle

    case = _case("patch_aug_net", tmp_path_factory)
    tensors = {k: torch.from_numpy(v) for k, v in reference_state_dict("patch_aug_net", case["variables"]).items()}
    path = tmp_path_factory.mktemp("pickled") / "with_args.pth"
    torch.save({"state_dict_encoder": tensors, "args": argparse.Namespace(lr=0.1)}, path)
    with pytest.raises(pickle.UnpicklingError):
        load_torch_checkpoint(str(path), "patch_aug_net", case["cfg"], get_model("patch_aug_net", case["cfg"]))
