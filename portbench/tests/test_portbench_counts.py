"""The yardstick's counts against hand counts at a small shape: the model
FLOPs counted on the reference, and the K1/K2 bounds."""
import benchutil
from portbench import flops, yardstick
from portbench.reference import patch_aug_net, pptnet
from patchaugnet_tpu_torch import configs

SMALL = dict(configs.PATCH_AUG_NET_TRAIN, NUM_POINTS=256, SAMPLING=[64, 16, 4], KNN=[8, 8, 4])


def _mlp_macs(rows, widths, in_w):
    macs = 0
    for w in widths:
        macs += rows * in_w * w
        in_w = w
    return macs


def hand_count_patch_aug_net(cfg, n):
    """Two FLOPs per multiply-add of every product of the eval forward."""
    sap, knn, fs, ks, ds = cfg["SAMPLING"], cfg["KNN"], cfg["FEATURE_SIZE"], cfg["CLUSTER_SIZE"], cfg["OUTPUT_DIM"]
    macs, in_w = 0, 3
    for i, widths in enumerate(patch_aug_net.SA_WIDTHS):
        macs += _mlp_macs(sap[i] * knn[i], widths, in_w + 3)
        in_w = widths[-1]
    unknown = [sap[1], sap[0], n]                       # fp2, fp1, fp0 rows
    for rows, (w_in, widths) in zip(unknown, patch_aug_net._fp_widths(cfg)):
        macs += _mlp_macs(rows, widths, w_in)
    for rows, c, k in zip([sap[1], sap[0], n], fs, ks):  # each VLAD: assignment and aggregation
        macs += 2 * rows * c * k
    macs += sum(ks) * ds[0] * ds[0] + ds[0] * sum(ks) * ds[0]   # AFA: attention product and FC
    return 2 * macs


def test_forward_flops_match_hand_count():
    counted = flops.forward_flops(patch_aug_net, SMALL, 256)
    assert counted == hand_count_patch_aug_net(SMALL, 256)


def test_stored_forward_flops_match_hand_count():
    """The stored per-cloud count at the cell's shape is the hand count."""
    import json
    import os

    full = dict(configs.PATCH_AUG_NET_TRAIN)
    stored = json.load(open(os.path.join(benchutil.BENCH, "workloads", "pan.serve.b100.json")))
    assert stored["model_flops_per_item"] == hand_count_patch_aug_net(full, 4096)


def test_pptnet_flops_counted():
    small = dict(configs.PPTNET_ORIGIN, NUM_POINTS=256, SAMPLING=[64, 32, 16, 4], KNN=[8, 8, 8, 4])
    assert flops.forward_flops(pptnet, small, 256) > 0


def test_kernel_bounds_hand_count():
    # K1: 2 clouds of 64 points, 16 picks: 2*64*12 + 2*16*4 bytes, 2*15*64*10 operations
    t_bytes = (2 * 64 * 12 + 2 * 16 * 4) / 3.35e12
    t_ops = (2 * 15 * 64 * 10) / 67e12
    assert yardstick.fps_bound_s(2, 64, 16) == max(t_bytes, t_ops)
    # K2: 2 clouds, 64 candidates, 16 queries, k=8
    t_bytes = (2 * (64 + 16) * 12 + 2 * 16 * 8 * 8) / 3.35e12
    t_ops = (2 * 16 * 64 * 10) / 67e12
    assert yardstick.knn_bound_s(2, 64, 16, 8) == max(t_bytes, t_ops)
    # at SA0 of the served batch the operations bound both
    assert yardstick.fps_bound_s(100, 4096, 1024) == 100 * 1023 * 4096 * 10 / 67e12
    assert yardstick.knn_bound_s(100, 4096, 1024, 20) == 100 * 1024 * 4096 * 10 / 67e12
