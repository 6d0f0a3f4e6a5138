"""The benchmark's generators: the same seed gives the same inputs and
weights, another seed others."""
import numpy as np
import torch

import benchutil
from portbench import scene, weights
from portbench.reference import patch_aug_net, pptnet
from patchaugnet_tpu_torch import configs

BIG_SEED = 2**31 + 12345


def test_scene_clouds_per_seed():
    a = scene.scene_clouds(scene.rng_for(BIG_SEED, 1), 3, 512)
    b = scene.scene_clouds(scene.rng_for(BIG_SEED, 1), 3, 512)
    c = scene.scene_clouds(scene.rng_for(BIG_SEED + 1, 1), 3, 512)
    d = scene.scene_clouds(scene.rng_for(BIG_SEED, 2), 3, 512)
    assert a.shape == (3, 512, 3) and a.dtype == np.float32
    assert np.array_equal(a, b)
    assert not np.allclose(a, c) and not np.allclose(a, d)
    radius = np.sqrt((a ** 2).sum(-1)).max(axis=1)
    np.testing.assert_allclose(radius, 1.0, rtol=1e-6)
    np.testing.assert_allclose(a.mean(axis=1), 0.0, atol=1e-6)


def test_scene_has_its_parts():
    pc = scene.scene_clouds(scene.rng_for(3, 1), 1, 4096)[0]
    n_g = int(4096 * scene.GROUND_SHARE)
    ground_z = pc[:n_g, 2]
    assert ground_z.std() < pc[n_g:, 2].std()          # the ground is flatter than facades and clutter


def test_weights_per_seed():
    spec = patch_aug_net.spec(dict(configs.PATCH_AUG_NET_TRAIN))
    a = weights.make_weights(spec, BIG_SEED, "cpu")
    b = weights.make_weights(spec, BIG_SEED, "cpu")
    c = weights.make_weights(spec, BIG_SEED + 1, "cpu")
    assert sorted(a) == sorted(n for n, _ in spec)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(torch.equal(a[k], c[k]) for k in a)
    assert ((a["sa0.mlp.bn0.running_var"] >= 0.5) & (a["sa0.mlp.bn0.running_var"] < 1.5)).all()
    w = a["fp0.mlp.layer0.weight"]                      # (256, 259): std 1/sqrt(259)
    assert abs(float(w.std()) * 259 ** 0.5 - 1.0) < 0.02


def test_weights_fan_overrides():
    cfg = dict(configs.PPTNET_ORIGIN)
    spec = pptnet.spec(cfg)
    w = weights.make_weights(spec, 7, "cpu", {"hidden_weights": 256, "kernel": "rows"})
    assert abs(float(w["aggregation.hidden_weights"].std()) * 16 - 1.0) < 0.02
    k = w["sa3.sa.qk_conv.kernel"]                      # (8, 64, 64): fan 512
    assert abs(float(k.std()) * 512 ** 0.5 - 1.0) < 0.05


def test_train_pool_per_seed(tmp_path):
    import time

    root = benchutil.small_checkout(str(tmp_path), "patch_aug_net", benchutil.TRAIN_TRAFFIC,
                                    benchutil.TRAIN_WORKLOAD, benchutil.SMALL_MODEL)
    from portbench import harness, program

    kind = harness.load_module(f"{root}/portbench/traffic/train.py", "train_kind")
    pools = []
    for seed in (BIG_SEED, BIG_SEED, BIG_SEED + 1):
        run = harness.prepare("small", seed, 0.0, False, time.perf_counter(), device="cpu", root=root)
        pools.append(kind.make_pool(run, program.model_config(run)))
    (c0, t0, m0), (c1, t1, m1), (c2, t2, _) = pools
    assert torch.equal(c0, c1) and torch.equal(t0, t1) and torch.equal(m0, m1)
    assert not torch.equal(c0, c2) and not torch.equal(t0, t2)
    q, n, qi, pi, ni, pair, valid = t0[0]
    assert int(m0.sum()) == 2 * 3                        # 2 tuples, the query and 2 positives each
    assert bool(m0[q.long()].all()) and bool(m0[n.long()].all())
    assert int(pair.max()) < benchutil.SMALL_MODEL["A2B_MAX_PAIRS"]
