"""Read the reference's trained PyTorch checkpoints into the port's models.

The port's copy of ``patchaugnet_tpu/compat/torch_loader.py``. The
reference saves ``{'epoch', 'iter', 'optimizer', 'state_dict_encoder'}``
per epoch (train_place_recognition.py:172-189), and its eval loader also
takes bare state dicts (evaluate.py:150-158).
:func:`load_torch_checkpoint` reads either, converts the reference's
state-dict names and layouts into the JAX package's variable tree (numpy,
channels-last), and fills the port's model with the strict walk of
``compat.load_jax_variables``: the port's attribute names follow that
tree, so no second name mapping is needed.

Layout conversions (torch -> channels-last):
  - ``Conv2d(in, out, (1, 1))`` / ``Conv1d(in, out, 1)``: weight
    ``(out, in, 1[, 1])`` -> kernel ``(in, out)``;
  - ``Conv2d(1, out, (1, 3))`` (the coordinate-consuming convs of
    PointNetVLAD and its STN): ``(out, 1, 1, 3)`` -> ``(3, out)``;
  - ``Linear``: ``(out, in)`` -> ``(in, out)``;
  - grouped ``Conv1d(C, C, 1, groups=g)``: ``(C, C/g, 1)`` ->
    ``(g, C/g, C/g)`` block-diagonal kernel;
  - MinkowskiEngine kernels ``(K^3, Cin, Cout)`` -> ``(K, K, K, Cin, Cout)``,
    the spatial axes reversed (ME's first coordinate runs fastest), and the
    transposed convs' also flipped;
  - BatchNorm: weight/bias -> scale/bias (params), running_mean/var ->
    mean/var (batch_stats).

:func:`reference_state_dict` is the inverse: a JAX variable tree (for
example ``compat.to_jax_variables(model)``) as a state dict under the
reference's keys and layouts, holding exactly the keys the converters
take. The loader checks a checkpoint against it before converting, so a
missing key or a shape that does not fit raises and names the reference
key.

Deliberate divergence from the JAX loader: the checkpoint is read with
``torch.load(..., weights_only=True)``. The reference's dict holds only
tensors, numbers and the optimizer's state, which that reads; nothing in
it needs unpickling of arbitrary objects.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .jax_params import load_jax_variables, to_jax_variables

Tree = Dict[str, Any]


def _t_linear(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _t_conv1x1(w):
    w = np.asarray(w)
    return np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)


def _t_grouped_conv(w, gp: int):
    # (C_out, C_in/g, 1) -> (g, C_in/g, C_out/g): kernel[g, i, o] = w[g*cg+o, i, 0]
    w = np.asarray(w)[..., 0]                              # (C, cg)
    c, cg = w.shape
    return np.ascontiguousarray(w.reshape(gp, c // gp, cg).transpose(0, 2, 1))


def _identity(w):
    return np.asarray(w)


class StateDict:
    """A consuming view of a torch state dict (tracks unused keys)."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.used = set()

    def take(self, key: str, transform: Callable = _identity):
        if key not in self.sd:
            raise KeyError(f"torch state dict missing: {key}")
        self.used.add(key)
        return transform(self.sd[key])

    def unused(self):
        return sorted(set(self.sd) - self.used)


def _bn(sd: StateDict, prefix: str):
    """-> (params {scale, bias}, stats {mean, var})."""
    return (
        {"scale": sd.take(f"{prefix}.weight"), "bias": sd.take(f"{prefix}.bias")},
        {"mean": sd.take(f"{prefix}.running_mean"), "var": sd.take(f"{prefix}.running_var")},
    )


def _stn(sd: StateDict, prefix: str):
    """The reference's STN3d without BatchNorm (PointNetVlad.py:124-177)."""
    p: Tree = {}
    # conv1 takes the coordinate axis ((out, 1, 1, 3)) at k=3, else (out, in, 1, 1)
    w1 = np.asarray(sd.take(f"{prefix}.conv1.weight"))
    kernel1 = w1.reshape(w1.shape[0], -1).T if w1.shape[1] == 1 else w1.reshape(w1.shape[0], w1.shape[1]).T
    p["conv1"] = {"kernel": np.ascontiguousarray(kernel1), "bias": sd.take(f"{prefix}.conv1.bias")}
    for i in (2, 3):
        p[f"conv{i}"] = {"kernel": sd.take(f"{prefix}.conv{i}.weight", _t_conv1x1),
                         "bias": sd.take(f"{prefix}.conv{i}.bias")}
    for i in (1, 2, 3):
        p[f"fc{i}"] = {"kernel": sd.take(f"{prefix}.fc{i}.weight", _t_linear),
                       "bias": sd.take(f"{prefix}.fc{i}.bias")}
    return p


def _netvlad_loupe(sd: StateDict, prefix: str):
    """The reference's NetVLADLoupe (PointNetVlad.py:12-81)."""
    p: Tree = {
        "base": {"cluster_weights": sd.take(f"{prefix}.cluster_weights"),
                 "cluster_weights2": sd.take(f"{prefix}.cluster_weights2")},
        "hidden1_weights": sd.take(f"{prefix}.hidden1_weights"),
    }
    stats: Tree = {"base": {}}
    p["base"]["bn1"], stats["base"]["bn1"] = _bn(sd, f"{prefix}.bn1")
    p["bn2"], stats["bn2"] = _bn(sd, f"{prefix}.bn2")
    if f"{prefix}.context_gating.gating_weights" in sd.sd:
        p["context_gating"], stats["context_gating"] = _gating(sd, f"{prefix}.context_gating")
    return p, stats


def convert_pointnet_vlad(state_dict: Mapping[str, Any]):
    """The reference's ``PointNetVlad`` (feature_transform=True,
    max_pool=False, the conv stack with BatchNorm, STNs without)."""
    sd = StateDict(state_dict)
    pn_p: Tree = {"stn": _stn(sd, "point_net.stn"), "feature_trans": _stn(sd, "point_net.feature_trans")}
    pn_s: Tree = {}
    for i in range(1, 6):
        w = np.asarray(sd.take(f"point_net.conv{i}.weight"))
        kernel = w.reshape(w.shape[0], -1).T if i == 1 else w.reshape(w.shape[0], w.shape[1]).T
        pn_p[f"conv{i}"] = {"kernel": np.ascontiguousarray(kernel), "bias": sd.take(f"point_net.conv{i}.bias")}
        pn_p[f"conv{i}_bn"], pn_s[f"conv{i}_bn"] = _bn(sd, f"point_net.bn{i}")
    nv_p, nv_s = _netvlad_loupe(sd, "net_vlad")
    return {"params": {"point_net": pn_p, "net_vlad": nv_p},
            "batch_stats": {"point_net": pn_s, "net_vlad": nv_s}}, sd.unused()


def _shared_mlp(sd: StateDict, prefix: str):
    """pt_util.SharedMLP: a 1x1 conv without bias and a BatchNorm per layer."""
    p, stats = {}, {}
    j = 0
    while f"{prefix}.layer{j}.conv.weight" in sd.sd:
        p[f"layer{j}"] = {"kernel": sd.take(f"{prefix}.layer{j}.conv.weight", _t_conv1x1)}
        p[f"bn{j}"], stats[f"bn{j}"] = _bn(sd, f"{prefix}.layer{j}.bn.bn")
        j += 1
    return p, stats


def _vlad_base(sd: StateDict, prefix: str):
    """NetVLADBase inside the spatial-pyramid VLADs: only the cluster weights
    and bn1 feed the forward (loupe.py:191-222); each VLAD's
    hidden1_weights, bn2 and context_gating are built but dead, and left unused."""
    p = {"cluster_weights": sd.take(f"{prefix}.cluster_weights"),
         "cluster_weights2": sd.take(f"{prefix}.cluster_weights2")}
    stats = {}
    p["bn1"], stats["bn1"] = _bn(sd, f"{prefix}.bn1")
    return p, stats


def _gating(sd: StateDict, prefix: str):
    p = {"gating_weights": sd.take(f"{prefix}.gating_weights")}
    stats = {}
    p["bn1"], stats["bn1"] = _bn(sd, f"{prefix}.bn1")
    return p, stats


def _afa(sd: StateDict, prefix: str):
    """AdaptiveFeatureAggregator: mlpa's first conv (trans_conv and
    after_norm are the dead 'way 1', loupe.py:34-38), fc, bn."""
    p = {
        "mlpa": {"mlp0": {"kernel": sd.take(f"{prefix}.mlpa.mlps.0.weight", _t_conv1x1)}},
        "fc": {"kernel": sd.take(f"{prefix}.fc.weight", _t_linear), "bias": sd.take(f"{prefix}.fc.bias")},
    }
    stats = {}
    p["bn"], stats["bn"] = _bn(sd, f"{prefix}.bn")
    return p, stats


def _group_sa(sd: StateDict, prefix: str, gp: int):
    """SA_Layer / GroupSALayer with the tied q/k grouped convs."""
    p = {
        "qk_conv": {"kernel": sd.take(f"{prefix}.q_conv.weight", lambda w: _t_grouped_conv(w, gp))},
        "v_conv": {"kernel": sd.take(f"{prefix}.v_conv.weight", _t_conv1x1),
                   "bias": sd.take(f"{prefix}.v_conv.bias")},
        "trans_conv": {"kernel": sd.take(f"{prefix}.trans_conv.weight", _t_conv1x1),
                       "bias": sd.take(f"{prefix}.trans_conv.bias")},
    }
    # k_conv.weight is q_conv.weight (tied)
    if f"{prefix}.k_conv.weight" in sd.sd:
        sd.take(f"{prefix}.k_conv.weight")
    stats = {}
    p["after_norm"], stats["after_norm"] = _bn(sd, f"{prefix}.after_norm")
    return p, stats


def _backbone(sd: StateDict, n_sa: int, n_fp: int, gp: Optional[int] = None):
    """The SA and FP stacks of PPT-Net and PatchAugNet."""
    p: Tree = {}
    stats: Tree = {}
    for i in range(n_sa):
        mp, ms = _shared_mlp(sd, f"backbone.SA_modules.{i}.mlps.0")
        p[f"sa{i}"], stats[f"sa{i}"] = {"mlp": mp}, {"mlp": ms}
        if gp is not None:
            p[f"sa{i}"]["sa"], stats[f"sa{i}"]["sa"] = _group_sa(sd, f"backbone.SA_modules.{i}.sas.0", gp)
    for i in range(n_fp):
        mp, ms = _shared_mlp(sd, f"backbone.FP_modules.{i}.mlp")
        p[f"fp{i}"], stats[f"fp{i}"] = {"mlp": mp}, {"mlp": ms}
    return p, stats


def convert_patch_aug_net(state_dict: Mapping[str, Any]):
    """The reference's patch_aug_net.Network (AGGREGATION_TYPE=2, use_a2a_recon)."""
    sd = StateDict(state_dict)
    params, stats = _backbone(sd, n_sa=3, n_fp=3)
    agg_p: Tree = {}
    agg_s: Tree = {}
    for i in range(3):
        agg_p[f"vlad{i}"], agg_s[f"vlad{i}"] = _vlad_base(sd, f"aggregation.vlads.{i}")
    agg_p["afa"], agg_s["afa"] = _afa(sd, "aggregation.afa")
    if "aggregation.context_gating.gating_weights" in sd.sd:
        agg_p["context_gating"], agg_s["context_gating"] = _gating(sd, "aggregation.context_gating")
    params["aggregation"], stats["aggregation"] = agg_p, agg_s
    if "decoder.fc1.weight" in sd.sd:
        dec_p: Tree = {}
        dec_s: Tree = {}
        for i in (1, 2, 3):
            dec_p[f"fc{i}"] = {"kernel": sd.take(f"decoder.fc{i}.weight", _t_linear),
                               "bias": sd.take(f"decoder.fc{i}.bias")}
        for i in (1, 2):
            dec_p[f"bn{i}"], dec_s[f"bn{i}"] = _bn(sd, f"decoder.bn{i}")
        params["decoder"], stats["decoder"] = dec_p, dec_s
    return {"params": params, "batch_stats": stats}, sd.unused()


def convert_pptnet(state_dict: Mapping[str, Any], gp: int = 8):
    """The reference's pptnet.Network (4 SA levels with grouped attention)."""
    sd = StateDict(state_dict)
    params, stats = _backbone(sd, n_sa=4, n_fp=4, gp=gp)
    agg_p: Tree = {}
    agg_s: Tree = {}
    for i in range(4):
        agg_p[f"vlad{i}"], agg_s[f"vlad{i}"] = _vlad_base(sd, f"aggregation.vlad{i}")
    agg_p["hidden_weights"] = sd.take("aggregation.hidden_weights")
    agg_p["bn2"], agg_s["bn2"] = _bn(sd, "aggregation.bn2")
    if "aggregation.context_gating.gating_weights" in sd.sd:
        agg_p["context_gating"], agg_s["context_gating"] = _gating(sd, "aggregation.context_gating")
    params["aggregation"], stats["aggregation"] = agg_p, agg_s
    return {"params": params, "batch_stats": stats}, sd.unused()


def _t_me_kernel(w, k: int):
    """MinkowskiConvolution kernel ``(K^3, Cin, Cout)`` -> ``(K, K, K, Cin, Cout)``.

    ME's kernel region runs the first coordinate fastest (linear index
    ``x + K*y + K^2*z``), so a C-order reshape gives ``[z][y][x]`` and the
    spatial axes are reversed into the grid's ``(x, y, z)`` order. (The
    JAX package documents this orientation; MinkowskiEngine does not
    install here to test it. Shapes, names and channels are exact.)"""
    w = np.asarray(w)
    v, cin, cout = w.shape
    if v != k ** 3:
        raise ValueError(f"ME kernel {w.shape}: expected {k ** 3} taps")
    return np.ascontiguousarray(w.reshape(k, k, k, cin, cout).transpose(2, 1, 0, 3, 4))


def _t_me_1x1(w):
    """ME 1x1 kernel ``(Cin, Cout)`` -> ``(1, 1, 1, Cin, Cout)``."""
    w = np.asarray(w)
    return np.ascontiguousarray(w.reshape(1, 1, 1, *w.shape))


def _t_me_tconv_kernel(w, k: int):
    """MinkowskiConvolutionTranspose kernel ``(K^3, Cin, Cout)`` -> the
    transposed conv's ``(K, K, K, Cin, Cout)``: :func:`_t_me_kernel` and a
    flip of the three spatial axes (ME scatters with the unflipped
    kernel, the port's transposed conv holds flax's flipped one; the JAX
    package's shim-ME forward diff, tests/test_minkloc_ref_parity.py)."""
    return np.ascontiguousarray(_t_me_kernel(w, k)[::-1, ::-1, ::-1])


def _me_conv_bn(sd: StateDict, conv_key: str, bn_prefix: str, k: int):
    kernel = sd.take(conv_key, _t_me_1x1) if k == 1 else sd.take(conv_key, lambda w: _t_me_kernel(w, k))
    bn_p, bn_s = _bn(sd, bn_prefix)
    return {"conv": {"kernel": kernel}, "bn": bn_p}, {"bn": bn_s}


def convert_minkloc3dv2(
    state_dict: Mapping[str, Any],
    planes=(64, 128, 64, 32),
    layers=(1, 1, 1, 1),
    num_top_down: int = 2,
    conv0_kernel_size: int = 5,
    block: str = "ECABasicBlock",
    pooling: str = "GeM",
):
    """The reference's MinkLoc (MinkFPN backbone + PoolingWrapper): conv0/bn0;
    convs.{i}/bn.{i}, the stride-2 downsamples; blocks.{i}.{j} (conv1,
    norm1, conv2, norm2 [, eca.conv, downsample.0/1]); conv1x1.{i}, the
    laterals; tconvs.{i}, the top-down transposed convs; pooling.pooling.p
    (GeM) or pooling.pooling.net_vlad.* (netvlad, netvladgc) (minkfpn.py:31-62).
    One tree fills both of the port's backends."""
    sd = StateDict(state_dict)
    p: Tree = {}
    s: Tree = {}
    p["conv0"], s["conv0"] = _me_conv_bn(sd, "backbone.conv0.kernel", "backbone.bn0.bn", conv0_kernel_size)
    for i in range(len(layers)):
        p[f"down{i}"], s[f"down{i}"] = _me_conv_bn(sd, f"backbone.convs.{i}.kernel", f"backbone.bn.{i}.bn", 2)
        for j in range(layers[i]):
            pref = f"backbone.blocks.{i}.{j}"
            bp: Tree = {}
            bs: Tree = {}
            bp["conv1"], bs["conv1"] = _me_conv_bn(sd, f"{pref}.conv1.kernel", f"{pref}.norm1.bn", 3)
            bp["conv2"], bs["conv2"] = _me_conv_bn(sd, f"{pref}.conv2.kernel", f"{pref}.norm2.bn", 3)
            if block == "ECABasicBlock":
                # torch Conv1d(1, 1, k) weight (1, 1, k) -> (k, 1, 1)
                bp["eca"] = {"conv": {"kernel": sd.take(
                    f"{pref}.eca.conv.weight",
                    lambda w: np.ascontiguousarray(np.asarray(w).reshape(1, 1, -1).transpose(2, 1, 0)))}}
            if f"{pref}.downsample.0.kernel" in sd.sd:
                bp["downsample"], bs["downsample"] = _me_conv_bn(
                    sd, f"{pref}.downsample.0.kernel", f"{pref}.downsample.1.bn", 1)
            p[f"block{i}_{j}"], s[f"block{i}_{j}"] = bp, bs
    p["lateral0"] = {"kernel": sd.take("backbone.conv1x1.0.kernel", _t_me_1x1)}
    for i in range(num_top_down):
        p[f"tconv{i}"] = {"kernel": sd.take(f"backbone.tconvs.{i}.kernel", lambda w: _t_me_tconv_kernel(w, 2))}
        p[f"lateral{i + 1}"] = {"kernel": sd.take(f"backbone.conv1x1.{i + 1}.kernel", _t_me_1x1)}
    params: Tree = {"backbone": p}
    stats: Tree = {"backbone": s}
    if pooling == "GeM":
        params["pooling"] = {"p": sd.take("pooling.pooling.p")}
    elif pooling in ("netvlad", "netvladgc"):
        nv_p, nv_s = _netvlad_loupe(sd, "pooling.pooling.net_vlad")
        params["pooling"], stats["pooling"] = {"net_vlad": nv_p}, {"net_vlad": nv_s}
    # MAC and SPoC have no parameters
    return {"params": params, "batch_stats": stats}, sd.unused()


def _minkloc_args(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    return dict(planes=tuple(cfg.get("planes", (64, 128, 64, 32))), layers=tuple(cfg.get("layers", (1, 1, 1, 1))),
                num_top_down=cfg.get("num_top_down", 2), conv0_kernel_size=cfg.get("conv0_kernel_size", 5),
                block=cfg.get("block", "ECABasicBlock"), pooling=cfg.get("pooling", "GeM"))


_CONVERTERS = {
    "pointnet_vlad": convert_pointnet_vlad,
    "patch_aug_net": convert_patch_aug_net,
    "pptnet": convert_pptnet,
    "pptnet_l2_norm": convert_pptnet,
    "minkloc3dv2": convert_minkloc3dv2,
}


def convert(state_dict: Mapping[str, Any], model_type: str, cfg: Mapping[str, Any]) -> Tuple[Tree, list]:
    """A reference state dict (numpy or torch values) -> (JAX variable tree,
    the keys no converter took)."""
    if model_type not in _CONVERTERS:
        raise NotImplementedError(f"torch checkpoint import is not wired for model_type={model_type}; "
                                  f"available: {sorted(_CONVERTERS)}")
    if model_type == "minkloc3dv2":
        return convert_minkloc3dv2(state_dict, **_minkloc_args(cfg))
    return _CONVERTERS[model_type](state_dict)


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The state dict of a reference checkpoint, wrapped
    (``state_dict_encoder``) or bare, as numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = obj.get("state_dict_encoder", obj) if isinstance(obj, dict) else obj
    return {k: v.numpy() for k, v in state_dict.items() if isinstance(v, torch.Tensor)}


def load_torch_checkpoint(path: str, model_type: str, cfg: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Fill ``model`` (of ``model_type``, built from ``cfg``) from the
    reference checkpoint at ``path``; returns ``model``.

    Strict: a key the converter needs that the checkpoint lacks raises
    ``KeyError``, a shape that does not fit the model raises
    ``ValueError``, each naming the reference key; a leaf of the converted
    tree that no module takes raises too. Keys no converter reads (the
    reference's dead weights, ``num_batches_tracked``) are left, as the JAX
    loader leaves them.
    """
    state_dict = read_state_dict(path)
    want = reference_state_dict(model_type, to_jax_variables(model), cfg)
    for key, value in want.items():
        if key not in state_dict:
            raise KeyError(f"torch state dict missing: {key}")
        if state_dict[key].shape != value.shape:
            raise ValueError(f"{key}: shape {state_dict[key].shape} in {path}, the model takes {value.shape}")
    variables, _ = convert(state_dict, model_type, cfg)
    return load_jax_variables(model, variables)


# ---------------------------------------------------------------------------
# The inverse: a JAX variable tree under the reference's keys and layouts.

def _r_linear(k):
    return np.asarray(k).T


def _r_conv1x1(k, dims: int = 2):
    """(in, out) -> (out, in, 1, 1) (Conv2d), or (out, in, 1) with dims=1 (Conv1d)."""
    k = np.asarray(k)
    return k.T.reshape(k.shape[1], k.shape[0], *(1,) * dims)


def _r_grouped_conv(k):
    """(g, C/g, C/g) -> (C, C/g, 1): w[g*cg+o, i, 0] = kernel[g, i, o]."""
    k = np.asarray(k)
    g, cg_in, cg_out = k.shape
    return k.transpose(0, 2, 1).reshape(g * cg_out, cg_in, 1)


def _r_me_kernel(k):
    k = np.asarray(k)
    return k.transpose(2, 1, 0, 3, 4).reshape(-1, k.shape[3], k.shape[4])


def _r_me_tconv_kernel(k):
    return _r_me_kernel(np.asarray(k)[::-1, ::-1, ::-1])


def _r_me_1x1(k):
    k = np.asarray(k)
    return k.reshape(k.shape[3], k.shape[4])


class _Writer:
    """Collects a reference state dict as contiguous float32 numpy arrays."""

    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def put(self, key: str, value) -> None:
        self.sd[key] = np.ascontiguousarray(value)

    def bn(self, prefix: str, p: Mapping, s: Mapping) -> None:
        self.put(f"{prefix}.weight", p["scale"])
        self.put(f"{prefix}.bias", p["bias"])
        self.put(f"{prefix}.running_mean", s["mean"])
        self.put(f"{prefix}.running_var", s["var"])

    def shared_mlp(self, prefix: str, p: Mapping, s: Mapping) -> None:
        j = 0
        while f"layer{j}" in p:
            self.put(f"{prefix}.layer{j}.conv.weight", _r_conv1x1(p[f"layer{j}"]["kernel"]))
            self.bn(f"{prefix}.layer{j}.bn.bn", p[f"bn{j}"], s[f"bn{j}"])
            j += 1

    def gating(self, prefix: str, p: Mapping, s: Mapping) -> None:
        self.put(f"{prefix}.gating_weights", p["gating_weights"])
        self.bn(f"{prefix}.bn1", p["bn1"], s["bn1"])

    def vlad_base(self, prefix: str, p: Mapping, s: Mapping) -> None:
        self.put(f"{prefix}.cluster_weights", p["cluster_weights"])
        self.put(f"{prefix}.cluster_weights2", p["cluster_weights2"])
        self.bn(f"{prefix}.bn1", p["bn1"], s["bn1"])

    def netvlad_loupe(self, prefix: str, p: Mapping, s: Mapping) -> None:
        self.vlad_base(prefix, p["base"], s["base"])
        self.put(f"{prefix}.hidden1_weights", p["hidden1_weights"])
        self.bn(f"{prefix}.bn2", p["bn2"], s["bn2"])
        if "context_gating" in p:
            self.gating(f"{prefix}.context_gating", p["context_gating"], s["context_gating"])

    def backbone(self, p: Mapping, s: Mapping) -> None:
        i = 0
        while f"sa{i}" in p:
            self.shared_mlp(f"backbone.SA_modules.{i}.mlps.0", p[f"sa{i}"]["mlp"], s[f"sa{i}"]["mlp"])
            if "sa" in p[f"sa{i}"]:
                pref, ap, ast = f"backbone.SA_modules.{i}.sas.0", p[f"sa{i}"]["sa"], s[f"sa{i}"]["sa"]
                qk = _r_grouped_conv(ap["qk_conv"]["kernel"])
                self.put(f"{pref}.q_conv.weight", qk)
                self.put(f"{pref}.k_conv.weight", qk)
                for name in ("v_conv", "trans_conv"):
                    self.put(f"{pref}.{name}.weight", _r_conv1x1(ap[name]["kernel"], dims=1))
                    self.put(f"{pref}.{name}.bias", ap[name]["bias"])
                self.bn(f"{pref}.after_norm", ap["after_norm"], ast["after_norm"])
            i += 1
        i = 0
        while f"fp{i}" in p:
            self.shared_mlp(f"backbone.FP_modules.{i}.mlp", p[f"fp{i}"]["mlp"], s[f"fp{i}"]["mlp"])
            i += 1

    def me_conv_bn(self, conv_key: str, bn_prefix: str, p: Mapping, s: Mapping) -> None:
        kernel = p["conv"]["kernel"]
        self.put(conv_key, _r_me_1x1(kernel) if kernel.shape[0] == 1 else _r_me_kernel(kernel))
        self.bn(bn_prefix, p["bn"], s["bn"])


def _ref_patch_aug_net(w: _Writer, p: Mapping, s: Mapping) -> None:
    w.backbone(p, s)
    agg, aggs = p["aggregation"], s["aggregation"]
    for i in range(3):
        w.vlad_base(f"aggregation.vlads.{i}", agg[f"vlad{i}"], aggs[f"vlad{i}"])
    w.put("aggregation.afa.mlpa.mlps.0.weight", _r_conv1x1(agg["afa"]["mlpa"]["mlp0"]["kernel"], dims=1))
    w.put("aggregation.afa.fc.weight", _r_linear(agg["afa"]["fc"]["kernel"]))
    w.put("aggregation.afa.fc.bias", agg["afa"]["fc"]["bias"])
    w.bn("aggregation.afa.bn", agg["afa"]["bn"], aggs["afa"]["bn"])
    if "context_gating" in agg:
        w.gating("aggregation.context_gating", agg["context_gating"], aggs["context_gating"])
    if "decoder" in p:
        for i in (1, 2, 3):
            w.put(f"decoder.fc{i}.weight", _r_linear(p["decoder"][f"fc{i}"]["kernel"]))
            w.put(f"decoder.fc{i}.bias", p["decoder"][f"fc{i}"]["bias"])
        for i in (1, 2):
            w.bn(f"decoder.bn{i}", p["decoder"][f"bn{i}"], s["decoder"][f"bn{i}"])


def _ref_pptnet(w: _Writer, p: Mapping, s: Mapping) -> None:
    w.backbone(p, s)
    agg, aggs = p["aggregation"], s["aggregation"]
    for i in range(4):
        w.vlad_base(f"aggregation.vlad{i}", agg[f"vlad{i}"], aggs[f"vlad{i}"])
    w.put("aggregation.hidden_weights", agg["hidden_weights"])
    w.bn("aggregation.bn2", agg["bn2"], aggs["bn2"])
    if "context_gating" in agg:
        w.gating("aggregation.context_gating", agg["context_gating"], aggs["context_gating"])


def _ref_pointnet_vlad(w: _Writer, p: Mapping, s: Mapping) -> None:
    pn, pns = p["point_net"], s["point_net"]
    for name in ("stn", "feature_trans"):
        stn = pn[name]
        k1 = np.asarray(stn["conv1"]["kernel"])
        # (3, out) -> (out, 1, 1, 3); (in, out) -> (out, in, 1, 1)
        w.put(f"point_net.{name}.conv1.weight",
              k1.T.reshape(k1.shape[1], 1, 1, 3) if k1.shape[0] == 3 else _r_conv1x1(k1))
        w.put(f"point_net.{name}.conv1.bias", stn["conv1"]["bias"])
        for i in (2, 3):
            w.put(f"point_net.{name}.conv{i}.weight", _r_conv1x1(stn[f"conv{i}"]["kernel"]))
            w.put(f"point_net.{name}.conv{i}.bias", stn[f"conv{i}"]["bias"])
        for i in (1, 2, 3):
            w.put(f"point_net.{name}.fc{i}.weight", _r_linear(stn[f"fc{i}"]["kernel"]))
            w.put(f"point_net.{name}.fc{i}.bias", stn[f"fc{i}"]["bias"])
    for i in range(1, 6):
        k = np.asarray(pn[f"conv{i}"]["kernel"])
        w.put(f"point_net.conv{i}.weight", k.T.reshape(k.shape[1], 1, 1, k.shape[0]) if i == 1 else _r_conv1x1(k))
        w.put(f"point_net.conv{i}.bias", pn[f"conv{i}"]["bias"])
        w.bn(f"point_net.bn{i}", pn[f"conv{i}_bn"], pns[f"conv{i}_bn"])
    w.netvlad_loupe("net_vlad", p["net_vlad"], s["net_vlad"])


def _ref_minkloc3dv2(w: _Writer, p: Mapping, s: Mapping, cfg: Mapping[str, Any]) -> None:
    args = _minkloc_args(cfg)
    bb, bbs = p["backbone"], s["backbone"]
    w.me_conv_bn("backbone.conv0.kernel", "backbone.bn0.bn", bb["conv0"], bbs["conv0"])
    for i, n_blocks in enumerate(args["layers"]):
        w.me_conv_bn(f"backbone.convs.{i}.kernel", f"backbone.bn.{i}.bn", bb[f"down{i}"], bbs[f"down{i}"])
        for j in range(n_blocks):
            pref, bp, bs = f"backbone.blocks.{i}.{j}", bb[f"block{i}_{j}"], bbs[f"block{i}_{j}"]
            w.me_conv_bn(f"{pref}.conv1.kernel", f"{pref}.norm1.bn", bp["conv1"], bs["conv1"])
            w.me_conv_bn(f"{pref}.conv2.kernel", f"{pref}.norm2.bn", bp["conv2"], bs["conv2"])
            if "eca" in bp:
                w.put(f"{pref}.eca.conv.weight", np.asarray(bp["eca"]["conv"]["kernel"]).transpose(2, 1, 0))
            if "downsample" in bp:
                w.me_conv_bn(f"{pref}.downsample.0.kernel", f"{pref}.downsample.1.bn", bp["downsample"],
                             bs["downsample"])
    w.put("backbone.conv1x1.0.kernel", _r_me_1x1(bb["lateral0"]["kernel"]))
    for i in range(args["num_top_down"]):
        w.put(f"backbone.tconvs.{i}.kernel", _r_me_tconv_kernel(bb[f"tconv{i}"]["kernel"]))
        w.put(f"backbone.conv1x1.{i + 1}.kernel", _r_me_1x1(bb[f"lateral{i + 1}"]["kernel"]))
    pool = p.get("pooling", {})
    if "p" in pool:
        w.put("pooling.pooling.p", pool["p"])
    elif "net_vlad" in pool:
        w.netvlad_loupe("pooling.pooling.net_vlad", pool["net_vlad"], s["pooling"]["net_vlad"])


def reference_state_dict(model_type: str, variables: Mapping[str, Any],
                         cfg: Optional[Mapping[str, Any]] = None) -> Dict[str, np.ndarray]:
    """``variables`` (a JAX variable tree of ``model_type``, numpy) as the
    reference's state dict: its keys and layouts, the keys the converters
    take and no others. ``convert`` of the result gives ``variables`` back."""
    p, s = variables["params"], variables.get("batch_stats", {})
    w = _Writer()
    if model_type == "patch_aug_net":
        _ref_patch_aug_net(w, p, s)
    elif model_type in ("pptnet", "pptnet_l2_norm"):
        _ref_pptnet(w, p, s)
    elif model_type == "pointnet_vlad":
        _ref_pointnet_vlad(w, p, s)
    elif model_type == "minkloc3dv2":
        _ref_minkloc3dv2(w, p, s, cfg or {})
    else:
        raise NotImplementedError(f"no reference layout for model_type={model_type}; "
                                  f"available: {sorted(_CONVERTERS)}")
    return w.sd


def save_reference_checkpoint(path: str, model_type: str, model: nn.Module,
                              cfg: Optional[Mapping[str, Any]] = None, epoch: int = 0) -> None:
    """Write ``model``'s weights as the reference's per-epoch checkpoint
    (``{'epoch', 'iter', 'optimizer', 'state_dict_encoder'}``, the
    optimizer's state empty), readable by :func:`load_torch_checkpoint`
    and by the JAX package's loader."""
    sd = reference_state_dict(model_type, to_jax_variables(model), cfg)
    torch.save({"epoch": epoch, "iter": 0, "optimizer": {},
                "state_dict_encoder": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
