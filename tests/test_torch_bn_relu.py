"""Eval BatchNorm + ReLU in one pass (``ops.norm.bn_relu``, ``pan::bn_relu``)
and the dispatch of ``nn.BatchNorm.relu`` on the CPU.

The CPU implementation is the module's own expression, so the eval
forwards stay what they were bit for bit; these tests hold the operator
to ``torch.relu(bn(x))`` in every bit, count the sites that take it in
the PatchAugNet, PPT-Net and PointNetVLAD eval forwards, check that the
train step, bf16 and a forward that needs gradients keep the two
modules, and that an exported program holds the operator. The kernel's own tests are in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from patchaugnet_tpu_torch import configs, ops
from patchaugnet_tpu_torch.models import get_model
from patchaugnet_tpu_torch.nn import BatchNorm, SharedMLP, core, seeded_init_

TINY = {"patch_aug_net": dict(configs.PATCH_AUG_NET, NUM_POINTS=128, SAMPLING=[32, 8, 4], KNN=[8, 8, 4],
                              MAX_SAMPLES=[8, 32, 128]),
        "pptnet": dict(configs.PPTNET_ORIGIN, NUM_POINTS=128, SAMPLING=[32, 16, 8, 4], KNN=[8, 8, 4, 4],
                       FEATURE_SIZE=[32] * 4, OUTPUT_DIM=[32] * 4, CLUSTER_SIZE=[1, 2, 4, 8],
                       MAX_SAMPLES=[8, 16, 32, 128]),
        "pointnet_vlad": dict(configs.POINTNET_VLAD, NUM_POINTS=128)}
# eval BatchNorm -> ReLU sites of one forward: 16 SharedMLP layers (SA 3 x 3, FP 2 + 2 + 3);
# PPT-Net 12 SA and 9 FP layers and the 4 GroupSA after_norms; PointNetVLAD conv1-conv4
SITES = {"patch_aug_net": 16, "pptnet": 25, "pointnet_vlad": 4}


def _bn(c, seed=0):
    return seeded_init_(BatchNorm(c), torch.Generator().manual_seed(seed)).eval()


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.fixture
def counts():
    """``nn.core.bn_relu_counts``, zeroed."""
    core.bn_relu_counts.update(fused=0, unfused=0)
    return core.bn_relu_counts


@pytest.mark.parametrize("shape", [(5, 32), (3, 7, 12), (9, 3), (1, 1), (0, 16)],
                         ids=["rows", "rank3", "c3", "c1", "no_rows"])
def test_plain_is_the_module_expression(shape):
    """``pan::bn_relu`` on the CPU equals ``torch.relu(bn(x))`` of an eval
    BatchNorm in every bit, NaN and infinities included."""
    c = shape[-1]
    bn = _bn(c)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 3
    flat = x.view(-1)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0])
    flat[:min(flat.numel(), 5)] = specials[:min(flat.numel(), 5)]
    with torch.inference_mode():
        mul = torch.rsqrt(bn.running_var + core.BN_EPS) * bn.weight
        got = ops.bn_relu(x, bn.running_mean, mul, bn.bias)
        want = torch.relu(bn(x))
    assert got.shape == want.shape and torch.equal(_bits(got), _bits(want))


def test_refuses_what_the_kernel_does_not_take():
    bn = _bn(8)
    mul = torch.rsqrt(bn.running_var + core.BN_EPS) * bn.weight
    x = torch.randn(4, 8)
    with torch.inference_mode():
        for bad in (x.t().contiguous().t(), x.double(), torch.randn(4, 6), torch.tensor(1.0)):
            with pytest.raises(ValueError, match="pan::bn_relu"):
                ops.bn_relu(bad, bn.running_mean, mul, bn.bias)
        with pytest.raises(ValueError, match="mul"):
            ops.bn_relu(x, bn.running_mean, mul[:4], bn.bias)
        with pytest.raises(ValueError, match="bias"):
            ops.bn_relu(x, bn.running_mean, mul, bn.bias.double())


@pytest.mark.parametrize("model_type", sorted(SITES))
def test_eval_forward_fuses_every_site(model_type, counts, monkeypatch):
    """One eval forward under ``inference_mode`` takes ``pan::bn_relu`` at
    every BatchNorm -> ReLU site and returns what the two modules return."""
    model = seeded_init_(get_model(model_type, TINY[model_type]), torch.Generator().manual_seed(2)).eval()
    clouds = torch.rand(2, 128, 3, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got = model(clouds)
    assert counts == {"fused": SITES[model_type], "unfused": 0}
    monkeypatch.setattr(BatchNorm, "relu", lambda self, x: torch.relu(self(x)))
    with torch.inference_mode():
        want = model(clouds)
    leaves = torch.utils._pytree.tree_leaves
    for g, w in zip(leaves(got), leaves(want), strict=True):
        assert g is w is None or torch.equal(g, w)


@pytest.mark.parametrize("case", ["train", "grad", "bf16", "strided"])
def test_other_forwards_keep_the_two_modules(case, counts):
    """Train mode, an eval forward that records autograd, a bf16 input
    and a non-contiguous one take the BatchNorm then ``torch.relu`` (train
    mode uncounted), and give what those give."""
    mlp = seeded_init_(SharedMLP(5, [8, 12], dtype=torch.bfloat16 if case == "bf16" else None),
                       torch.Generator().manual_seed(4))
    x = torch.randn(3, 10, 5, generator=torch.Generator().manual_seed(5))
    if case == "train":
        y, unfused = mlp.train()(x), 0
    elif case == "grad":
        y, unfused = mlp.eval()(x.requires_grad_()), 2
        y.sum().backward()
        assert x.grad is not None and mlp.bn0.weight.grad is not None
    elif case == "bf16":
        with torch.inference_mode():
            y, unfused = mlp.eval()(x), 2
        assert y.dtype == torch.bfloat16
    else:
        bn, strided = _bn(5), x.transpose(0, 1).contiguous().transpose(0, 1)
        with torch.inference_mode():
            y, unfused = bn.relu(strided), 1
            assert torch.equal(_bits(y), _bits(torch.relu(bn(strided))))
    assert counts == {"fused": 0, "unfused": unfused}
    assert y.shape[:2] == (3, 10)


def test_exported_shared_mlp_holds_the_operator():
    """``torch.export`` of an eval SharedMLP under ``no_grad`` holds one
    ``pan.bn_relu`` node per layer (the fake implementation gives its
    shape), and the program returns the live module's bits."""
    mlp = seeded_init_(SharedMLP(5, [8, 12]), torch.Generator().manual_seed(6)).eval()
    x = torch.randn(2, 7, 5, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        program = torch.export.export(mlp, (x,))
        want = mlp(x)
    names = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert names.count("pan.bn_relu.default") == 2 and "aten.relu.default" not in names
    with torch.inference_mode():
        got = program.module()(x)
    assert torch.equal(_bits(got), _bits(want))
    assert np.isfinite(got.numpy()).all()
