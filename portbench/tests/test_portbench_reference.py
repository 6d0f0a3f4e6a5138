"""The plain reference against the port on the CPU, at the published
widths and a small batch: the eval forward of both models, and the
PatchAugNet train step (metrics, gradients, parameters after a step)."""
import copy

import pytest
import torch

import benchutil  # noqa: F401
from portbench.reference import patch_aug_net, pptnet, tuple_step
from portbench.reference.common import Net
from portbench.scene import rng_for, scene_clouds
from portbench.weights import make_weights, state_spec
from patchaugnet_tpu_torch import configs, serving, train
from patchaugnet_tpu_torch.losses import PatchCorrespondences
from patchaugnet_tpu_torch.models import get_model

FAN = {"patch_aug_net": {}, "pptnet": {"hidden_weights": 256, "kernel": "rows"}}


def _model_and_weights(cfg, seed):
    model = get_model(cfg["model_type"], cfg)
    spec = state_spec(model)
    ref = {"patch_aug_net": patch_aug_net, "pptnet": pptnet}[cfg["model_type"]]
    assert spec == sorted((n, tuple(s)) for n, s in ref.spec(cfg))
    w = make_weights(spec, seed, "cpu", FAN[cfg["model_type"]])
    model.load_state_dict(w)
    return model, ref, w


@pytest.mark.parametrize("cfg", [configs.PATCH_AUG_NET_TRAIN, configs.PPTNET_ORIGIN], ids=["patch_aug_net", "pptnet"])
def test_eval_forward_matches_reference(cfg):
    cfg = dict(cfg)
    model, ref, w = _model_and_weights(cfg, 11)
    x = torch.from_numpy(scene_clouds(rng_for(11, 1), 2, cfg["NUM_POINTS"]))
    got = serving.build_forward_fn(model, "cpu")(x)
    with torch.no_grad():
        want = ref.forward(Net(w), cfg, x)
    gap = (torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)).max()
    assert float(gap) < 1e-5


def test_train_step_matches_reference():
    cfg = dict(configs.PATCH_AUG_NET_TRAIN, TRAIN_BATCH_SIZE=1, TRAIN_NEGATIVES_PER_QUERY=2, NUM_POINTS=1024,
               SAMPLING=[256, 32, 8], A2B_MAX_ROWS=256)
    model, ref, w = _model_and_weights(cfg, 12)
    state = train.create_train_state(model, cfg, device="cpu")
    step = train.build_train_step(model, cfg)
    clouds = torch.from_numpy(scene_clouds(rng_for(12, 1), 6, 1024))
    mask = torch.tensor([True, True, True, False, False, False])
    g = torch.Generator().manual_seed(12)
    rows = cfg["A2B_MAX_ROWS"]
    pair = torch.randint(0, 2, (rows,), generator=g)
    tables = [torch.zeros(rows, dtype=torch.int32), 1 + pair] + [torch.randint(0, 256, (rows,), generator=g)
                                                                  for _ in range(3)] + [pair, pair >= 0]
    tables = [t.to(torch.int32) for t in tables]
    corr = PatchCorrespondences(*tables[:6], tables[6].bool(), cfg["A2B_MAX_PAIRS"])
    state, metrics = step(state, clouds, corr, mask)

    st = {"params": copy.copy(w), "m": {}, "v": {}, "t": 0}
    batch = tuple_step.Batch(clouds, mask, tuple(tables), cfg["A2B_MAX_PAIRS"])
    ref_metrics, grads = tuple_step.step(ref.forward, st, cfg, batch, cfg["BASE_LEARNING_RATE"])
    assert set(ref_metrics) == set(metrics) == {"place_recognition", "patch_recon_a2a", "patch_recon_a2b", "total"}
    for k, v in ref_metrics.items():
        assert abs(float(metrics[k]) - v) <= 1e-5 * abs(v), k
    for k, p in model.named_parameters():
        exp_avg = state.optimizer.state[p]["exp_avg"] / 0.1
        scale = max(float(grads[k].norm()), 1e-3)
        assert float((exp_avg - grads[k]).norm()) <= 1e-4 * scale, k
    now = model.state_dict()
    for k, v in st["params"].items():
        if tuple_step.is_stat(k):
            torch.testing.assert_close(now[k], v, rtol=1e-5, atol=1e-6)
