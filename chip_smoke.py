#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``patchaugnet_tpu_torch``).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel from ``patchaugnet_tpu_torch/csrc``
   with nvcc (sm_90a) into ``build/``, one nvcc per source, all at once,
   and print the ptxas register/spill report (a spill in any FPS
   instantiation fails);
2. kernels: at the shapes of the forward at B=32 (the three SA levels of
   FPS and kNN at k=20, the three FP levels' 3-NN on the kNN kernel, and
   the top-3 extraction of the FP levels' distance matrices, the route
   the 3-NN took before) and of the auction EMD at (4, 4096) (the
   price-fused top-2 on the full (4, 4096, 4096) base, and on its
   active-set tail: 256 rows per cloud read from that base through row
   ids padded with the sentinel, timed cold in L2 (eight id sets in
   turn: a call's rows were last read about 105 MB of rows earlier)
   beside the old route, a gather and K6 on the gathered rows; the
   two-level top-2 of a 8192-wide row chunk in one launch, beside flat
   K3), hold each kernel against its plain torch version on
   the card (indices and values exactly equal, K1 indices), on random,
   tied and all-equal inputs, K3, K4 and K6 also at every warps-per-row
   count the top-k kernel is built for, hold the 3-NN against the
   matrix-and-K3 route bit for bit, and time kernel, plain version and a
   PyTorch yardstick; K1 also at B=100 and at every layout (threads per
   cloud, points per thread) it is built for that holds the level; the
   fused eval BatchNorm + ReLU (``ops.bn_relu``) bit-equal to its four
   torch passes at the flagship's SA0 layer 0 and 2 and FP0 layer 0 shapes
   at B=100 (float4 path, NaN and infinities included) and on the scalar
   path (C=3, an input 4 bytes off alignment), timed beside them against
   its bytes bound;
3. serving: the full-width PatchAugNet (``configs.PATCH_AUG_NET``, seeded
   random weights) answers 4 requests of 32 clouds of 4096 points through
   ``serving.build_forward_fn``; the launch counts must be 3 FPS, 6 kNN
   and 16 fused BatchNorm + ReLU launches per forward and no other, the
   descriptors must be finite and unit-norm, and the same model run
   through the plain versions on the card (``BatchNorm.relu`` as the two
   modules) must give the same provenance indices and descriptors within
   1e-5; then descriptors/s at B=32 and B=100 and the peak device memory;
4. EMD: ``losses.emd_loss`` forward and backward on two (4, 4096, 3)
   clouds at the reference eps=0.02, iters=1024; K6 must have launched
   once per auction iteration plus once for the force-assign pass, the
   loss and gradient must be finite, and the assignment must equal the
   plain-kernel run on the card; then the opt-in ``unass_floor`` and
   ``eps_schedule`` modes beside it, and a short row-chunked auction at
   (1, 8192) that must launch K4 twice per sweep, once per 4096-row chunk
   (``profile_torch.py --emd`` breaks the exact call down by device
   kernel);
5. train: the full-width PatchAugNet with its patch branch and decoder
   (``configs.PATCH_AUG_NET_TRAIN``, seeded random weights, Adam at
   5e-4) through ``train.create_train_state``, ``train.build_center_fn``
   and ``train.build_train_step`` on one tuple batch of 4 x 18 = 72
   seeded random clouds of 4096 points, the 12 query and positive clouds
   in the patch branch, and seeded correspondence tables of 2048 rows and
   16 pairs; the centres must launch K1 once and each step K1 3 times and
   K2 6 times and no other kernel; one step from a copy of the state run
   through the plain versions on the card must give the same provenance
   indices, and metrics and new BatchNorm statistics within 1e-6; every
   loss term finite and positive, parameters and statistics changed and
   finite; then ms per step, clouds/s and peak device memory over 10
   steps after 3 warm-up steps; then the step with ``A2A_MAX_CLOUDS`` 8
   (the patch branch on 8 of the 12 query and positive clouds) held
   against the plain kernels' path the same way;
6. CLI: ``train_torch.py``'s ``main`` in this process on the flagship
   config (``configs/patch_aug_net.yaml``, 4096 points, 4 x 18 = 72 clouds
   per batch) and the synthetic scene for one epoch: up to 12 batches, the
   patch branch on the tables the data engine builds from synthetic
   overlap entries; each batch must launch K1 once for its centres and 3
   times and K2 6 times in its step, and no other kernel; every loss
   finite, the checkpoint written; the host's ms per batch in tuple
   sampling, synthetic overlaps, the centres (copy, FPS, read) and table
   building, and the same epoch again under the profiler for the card's
   idle share; then ``evaluate_torch.py``'s ``main`` on the untrained
   model (no ``--weight``) and on the checkpoint (descriptors unit-norm,
   the picks that decide recall@1 and 1% recall equal to the CPU
   retrieval's on the same descriptors at every query where they are not
   an exact near-tie within the f32 rounding bound (``check_recall``),
   the top-k dump written, K1 3, K2 6 and 16 fused BatchNorm + ReLU
   launches per eval forward), and the eval's descriptor sweep timed 10
   times after a warm-up; then the train split's descriptor refresh (the
   model in eval mode during it and back in train mode after) and
   hard-negative mining on the card, on the trained model's descriptors
   and on seeded random unit ones, equal to the CPU retrieval's lists at
   every rank that is not an exact near-tie within the f32 rounding
   bound of the distances (lists made to end in their farthest negative
   must fail that check); then K1 and K2 at the eval batch (100 clouds)
   and a refresh batch (36), bit-equal to the plain versions at every
   level, and the trained model on those batches through the kernels and
   through the plain versions (provenance indices equal, descriptors
   within 1e-5);
7. families: PPT-Net (``configs.PPTNET_ORIGIN``) and PointNetVLAD
   (``configs.POINTNET_VLAD``) at full width, seeded random weights: K1 and
   K2 at PPT-Net's level shapes (SA 4096 -> 1024 -> 256 -> 64 -> 16, k=20;
   FP 3-NN over 16, 64, 256 and 1024 known points) bit-equal to their plain
   versions at B=32, 100 and 18 on random and duplicated-grid clouds, the
   shapes a PatchAugNet forward does not launch timed at B=32; ``pptnet``
   served (4 requests of 32, 4 K1, 8 K2 and 25 fused BatchNorm + ReLU
   launches per forward, the plain
   path's provenance indices and descriptors within 1e-5), then
   descriptors/s at B=32 and B=100; ``pptnet_l2_norm`` on the same weights
   unit-norm; the PPT-Net train step at its tuple batch of 18 clouds held
   against the plain kernels from a deep copy (metrics and new BatchNorm
   statistics within 1e-6), then timed; PointNetVLAD served and its train
   step at 44 clouds timed, no kernel launched in the step (its eval
   forward launches the fused BatchNorm + ReLU 4 times, conv1-conv4, and
   is held against the plain path too); then for each family
   ``train_torch.py`` on the synthetic scene for two batches (no overlap
   tables) and ``evaluate_torch.py`` on its checkpoint (recall checked
   against the CPU retrieval's as in phase 6; PointNetVLAD's eval takes
   the global forward);
8. MinkLoc3Dv2 (``configs.MINKLOC3DV2``: the sparse voxel-table backend
   at step 0.01, full capacity, seeded random weights), which launches
   none of the port's kernels: 4 requests of 32 clouds served (no kernel
   launch, finite descriptors), then descriptors/s at B=32 and B=100 and
   the peak memory; 2 of the clouds through the same model on the CPU
   (coords, every level's keys and mask, every route and up map equal,
   descriptors within 1e-4); the level occupancy of the 32 served clouds;
   the dense backend at its capped 48^3 grid on 4 of them, its FPN output
   at the stored sites within 1e-5 of the sparse FPN's on the same
   occupancy, shared weights; the SmoothAP step (AdamW, MultiStepLR) on a
   pair-expanded batch of 16 clouds, one step from a deep copy on the
   CPU (loss and ap within 1e-5 relative, new BatchNorm statistics within
   1e-5), then 10 timed steps after 3 warm-up steps; ``train_torch.py``
   for two SmoothAP batches and ``evaluate_torch.py`` on its checkpoint,
   recall checked against the CPU retrieval's as in phase 6;
9. deployment: a full-width reference-layout ``.pth`` of
   ``configs.PATCH_AUG_NET`` (seeded) through ``export_serving_torch.py``'s
   ``main`` at B=32 and B=100, global and local (``torch.export``, K1 and
   K2 as the registered ``pan.fps`` / ``pan.knn``; the export launches
   nothing); the B=32 artifacts loaded in a fresh process that serves 4
   requests of 32 clouds, each call of each artifact launching K1 3, K2
   6 and the fused BatchNorm + ReLU 16 times and nothing else, with TF32 off and the port's models never
   imported; its descriptors, local features and centre indices equal to
   the live model fed the same ``.pth`` (floats within 1e-6, indices
   exactly); descriptors/s of the live forward and the artifact at B=32
   and B=100 in turns, with the host's time to queue one call; each
   artifact's size, export and cold-load seconds (the fresh process starts
   once the B=32 artifacts exist and serves while this one goes on);
   then PPT-Net's (4 K1, 8 K2 and 25 fused BatchNorm + ReLU per call),
   PointNetVLAD's (4 fused BatchNorm + ReLU) and MinkLoc3Dv2's (no
   launch) global artifacts at B=32, each held against
   its live forward; the fresh process also serves the bf16 PatchAugNet
   artifact at B=32 (``--precision bfloat16``, same ``.pth``), each call
   launching K1 3 and K2 6 times (its BatchNorm sees bf16: no fused one), with cuBLAS's bf16 reductions off, its
   descriptors f32 and bit-equal to the live bf16 forward's;
10. precision: mixed precision (``COMPUTE_DTYPE: bfloat16``) and ``REMAT``
   at full width. Each family (PatchAugNet, PPT-Net, PointNetVLAD,
   MinkLoc3Dv2) and its bf16 twin on the same seeded weights at B=32 and
   B=100: the bf16 descriptors f32, finite, within cosine 0.999 of the
   f32 forward's, the same K1/K2 launches (the f32 forward's fused
   BatchNorm + ReLU launches besides), PatchAugNet's and PPT-Net's
   provenance indices equal, MinkLoc3Dv2's tables and maps equal;
   descriptors/s of both in turns and each one's peak memory. The
   flagship bf16 train step at 72 clouds for three steps (K1 3 and K2 6
   each, metrics finite, every parameter, statistic and Adam moment f32),
   then ms per step of bf16 and f32 in turns; MinkLoc3Dv2's bf16 SmoothAP
   step at 16 clouds once. The flagship step with ``REMAT`` against the
   plain step from one copied state, both with deterministic algorithms
   (the gathers' atomic backward): the total within 1e-6 relative, the
   parameters within 1e-6, the running statistics equal (updated once),
   K1 6 and K2 12 launches (the recomputed forward); then ms per step and
   peak memory of both;
11. parallel (``parallel``, ``torch.distributed``): (a) a world of one
   rank under NCCL in this process: the flagship data-parallel step at 72
   clouds with ``A2A_MAX_CLOUDS`` 8 against ``build_train_step`` from the
   same state, deterministic algorithms on both (the total and the max
   parameter difference printed; both within 1e-5; the launches counted
   around the data-parallel step alone); (b) two ranks sharing
   the card over gloo (``parallel.spawn``): the data-parallel step at 36
   clouds a rank, the patch rows from both ranks (SGD, deterministic
   algorithms: total within 1e-5 relative, parameters and statistics
   within 1e-5 of the single-process step, every rank's the same), the
   sharded eval of PatchAugNet at B=100 (global, local and centres against
   the live local forward, within 1e-5 and equal), ``sharded_knn`` and
   ``sharded_fps`` at 4096 points over the two ranks (indices equal to
   K2's and K1's), the point-sharded PatchAugNet and PPT-Net descriptors
   at B=32 (within 1e-5 of ``build_forward_fn``), one
   ``build_sharded_train_step`` step of PPT-Net at 18 clouds (total within
   1e-5, every parameter's gradient within 1e-2 in relative L2, the
   operations that ran without a deterministic implementation named);
   each with its ms beside the single-process figure and its launches per
   rank; (c) ``train_torch.py`` for one batch and ``evaluate_torch.py`` at
   ``--devices 2 --share-device`` (the ranks' models equal; the
   descriptors within 1e-5 of ``--devices 1``'s, and every query whose
   first neighbour differs a tie within what that difference can swap);
12. extras (the device-side remainder): each piece on the card against
   the same port code on the CPU from the same inputs and weights, and,
   where K2 is on its path, against the plain kernels on the card; each
   with its ms per call and its K2 launches. The point ops at the
   flagship's SA0 shapes (B=32, 4096 points, the 1024 K1 centres,
   nsample 20, one cloud point in nine a duplicate) with a radius that
   leaves some queries short and some over-full (the shares printed):
   ``ball_query`` (and the peak memory of its matrices),
   ``knn_exclude_self`` (K2 once), ``self_sqdist``, every form of
   ``query_and_group_edge`` (kNN, K2 once; radius; given indices;
   xyz-only, K2 once; without xyz; the seeded shuffle as a permutation of
   the kNN's), ``query_and_group`` (kNN, K2 once; radius), ``group_all``,
   the label statistics with 13 classes, ``featuredistribute`` and
   ``featuregather`` with its backward: indices and counts equal, floats
   equal (the backward within 1e-5 of its largest value). The losses forward and backward
   within the CPU suite's tolerances: the miners at the flagship step's 72
   descriptors of 256, the quadruplet form, ``ot_loss`` and ``pps_loss``
   over 32 pairs of 128 x 128 sets of 256-d features with 8 candidates
   per row, the multi-similarity and focal losses. ``nn/extras.py`` in
   eval mode at d_model 256 over 128 positions, B=32, within 5e-5:
   ``SingleFeatProcessor`` and ``PairwiseFeatProcessor`` (distance + angle
   encoders, angle_k 3: K2 once per ``AngleEncoder`` call; NetVLAD;
   layers self, cross, self, cross), ``TransformerEncoderLayer`` (nhead
   4, feed-forward 2048, with and without ``linear_attention_k``), and
   ``CBAM`` (one fused BatchNorm + ReLU a call) and ``SEAttention`` over
   (32, 1024, 256);
13. host remainder: both host
   libraries of ``csrc/`` built with this machine's g++; FPFH native and
   numpy on a 4096-point submap cloud at the reference's defaults (radius
   0.05, max_nn 30/100; every row's 11-bin group sums within 1e-9, the
   share of exact rows and the mass moved within ``tests/test_fpfh.py``'s
   bounds), ms per cloud of each; a file-backed Oxford-format scene under
   ``PCR_DATA_ROOT`` in a temporary directory (two trips of float64 ``.bin``
   submaps of 4096 points and their CSVs), ``create_dataset_torch.py`` on
   it, the .pb overlap records written by ``save_overlap_pb`` from
   ``synthetic_overlaps`` on each query and positive, then
   ``train_torch.py`` on the flagship config for 2 batches with the patch
   losses (each batch's tables from the .pb, K1 3 + 1 and K2 6 launches per
   batch, the clouds through the native loader and equal to the numpy
   route's); ``utils.geometry.nn_angle`` at (32, 128) on the card against
   the CPU and the plain kernels (K2 once a call); ``get_overlap_indices``
   and ICP on two 4096-point clouds a known rigid transform apart (ICP
   recovers it within 1e-9), ms of each; one B=32 flagship forward under
   ``utils.profiling.trace``, whose Chrome trace names 3 ``pan::fps``, 6
   ``pan::knn`` and 16 ``pan::bn_relu`` calls and as many kernels of each
   on the card (the CLI
   run and the traced forward each in a fresh process where protobuf,
   TensorBoard, sklearn, pandas, PyYAML and matplotlib cannot be imported,
   and which fails on any attempt to import protobuf);
   ``compare_pose_errors``, and a plot that raises the ``ImportError``
   naming matplotlib where matplotlib is not installed;
14. quality: ``bench_quality_torch.run`` at full width (4096 points, 12
   epochs of 24 steps of 2 tuples of 1 + 2 + 6 + 1 clouds on the
   noise-hardened synthetic scene): PatchAugNet in f32 and in bf16,
   PPT-Net and PointNetVLAD, each trained recall@1 at least 55 and at
   least init + 5, its smallest epoch total below 0.6x the first epoch's
   (0.7x PPT-Net's and PointNetVLAD's), everything finite, the bf16
   flagship at most 5 points below the f32 one, and each run's K1, K2 and
   fused BatchNorm + ReLU launches exactly its steps', its patch centres'
   and its eval forwards' (none of the last in bf16);
   MinkLoc3Dv2's dense and sparse TruncatedSmoothAP runs (40 steps of 8
   clouds of 64 points) at least 85 and at least init + 20; the
   deterministic probe (``tests/torch_deterministic_probe.py``) in two
   fresh processes at once, their lines identical, the trained recall at
   least its pin and the bf16 serving leg at most 5 points below it;
   ``PointNet2SAModuleMSG`` at SA0's shapes (32 x 4096 points, 1024
   centres, a kNN scale of 20 at dilation 2 and a ball scale of 32 at
   radius 0.1) against the plain kernels (indices equal, features within
   1e-5; K1 1, K2 1 and 6 fused BatchNorm + ReLU launches); seconds per
   run and ms per step;
15. report: one ``{"kernels": [...]}`` line, the card's name and power
   limit as nvidia-smi gives them, and a last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or without
the rest of the repository. Imports nothing of JAX.
"""
import contextlib
import copy
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 32
N_POINTS = 4096
REQUESTS = 4
THROUGHPUT_BATCHES = ((32, 10), (100, 4))   # (batch size, timed batches)
PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM device memory (data sheet)
PEAK_F32_OPS_PER_S = 67e12                 # H100 SXM f32 outside the tensor cores
CARD = "unknown card"
# launches per eval forward: K1 at the three SA levels, K2 at the three SA
# and the three FP levels (the 3-NN), K3 nowhere, and the fused eval
# BatchNorm + ReLU at each of the 16 SharedMLP layers (a train step and a
# bf16 forward keep the two modules there: ``bf16_launches``)
FORWARD_LAUNCHES = {"fps": 3, "knn": 6, "bn_relu": 16}
PATCH_LEVELS = (1024, 128, 16)                # PatchAugNet's SA centres (configs/patch_aug_net.yaml)
PPT_LEVELS = (1024, 256, 64, 16)              # PPT-Net's (configs/pptnet_origin.yaml)
PPT_LAUNCHES = {"fps": 4, "knn": 8, "bn_relu": 25}  # a PPT-Net eval forward: 4 SA levels, 4 FP levels,
                                                    # 12 SA and 9 FP layers and 4 GroupSA after_norms
PPT_STEP_LAUNCHES = {"fps": 4, "knn": 8}      # a PPT-Net train step
PNV_LAUNCHES = {"bn_relu": 4}                 # a PointNetVLAD eval forward: conv1-conv4 (none in its step)
# the provenance indices of each family's output held equal on the kernel and the plain path
PROVENANCE = {"patch_aug_net": ("center_idx_origin", "sample_idx_origin"), "pptnet": ("center_idx_origin",)}
FAMILY_BATCHES = (32, 100, 18)                # serving, the eval batch, PPT-Net's tuple batch
FAMILY_CLI_BATCHES = 2                        # train_torch.py batches per family in phases 7 and 8
MINK_CPU_CLOUDS = 2                           # served clouds held against the CPU in phase 8
MINK_DENSE_CLOUDS = 4                         # clouds of the dense-against-sparse FPN check
MINK_STEP_CLOUDS = 16                         # the SmoothAP batch (SMOOTHAP_BATCH_SIZE's default)
MINK_DESC_TOL = 1e-4                          # descriptors, card against CPU
MINK_FPN_TOL = 1e-5                           # dense against sparse FPN at the stored sites
MINK_STEP_RTOL = 1e-5                         # SmoothAP loss and ap, card against CPU (relative)
MINK_STATS_TOL = 1e-5                         # new BatchNorm statistics, card against CPU
EMD_B, EMD_N, EMD_EPS, EMD_ITERS = 4, 4096, 0.02, 1024  # losses/pointnetvlad_loss.py:205-221
EMD_TAIL_ROWS = 256                                     # the active-set width R at n=4096
EMD_TAIL_VALID = (256, 240, 224, 208)                   # unassigned rows per cloud in the timed tail
TAIL_ID_SETS = 8                # tail ids taken in turn: a call's rows were last read ~105 MB of rows ago (L2: 50 MB)
SLEEP_CYCLES = 50_000_000       # holds the stream while the host queues a timed run (25 ms at 2 GHz)
CHUNKED_N, CHUNKED_ITERS = 8192, 20                     # a row-chunked auction, K4 on its path
# the train step (configs/patch_aug_net.yaml): K1 at the three SA levels,
# K2 at the three SA and the three FP levels, per step; K1 once more for
# the host's patch centres
STEP_LAUNCHES = {"fps": 3, "knn": 6}
CENTER_LAUNCHES = {"fps": 1}
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
CLI_CONFIG = "configs/patch_aug_net.yaml"     # the CLIs' flagship run on the synthetic scene
F32_UNIT = 2.0 ** -24                         # unit roundoff of f32 (the mining check's bound)
EVAL_REPEATS = 10                             # timed eval sweeps of the test split after the CLI's eval
DEPLOY_BATCHES = (32, 100)                    # the batch sizes exported in phase 9
DEPLOY_TOL = 1e-6                             # float outputs of an artifact against the live forward
ENQUEUE_REPS = 5                              # calls queued behind a sleep kernel per host-cost reading
# the fused eval BatchNorm + ReLU timed at B=100 (rows, C): the flagship's
# SA0 layers 0 and 2 and FP0 layer 0
BN_RELU_CASES = (("SA0 layer 0", 100 * 1024 * 20, 32), ("SA0 layer 2", 100 * 1024 * 20, 64),
                 ("FP0 layer 0", 100 * 4096, 256))
# phase 10: each family's config, its kernel launches per f32 forward
PRECISION_FAMILIES = (("patch_aug_net", "PATCH_AUG_NET", FORWARD_LAUNCHES), ("pptnet", "PPTNET_ORIGIN", PPT_LAUNCHES),
                      ("pointnet_vlad", "POINTNET_VLAD", PNV_LAUNCHES), ("minkloc3dv2", "MINKLOC3DV2", {}))
PRECISION_BATCHES = ((32, 5), (100, 2))       # (batch size, timed batches per turn)
PRECISION_STEPS = 3                           # bf16 train steps checked, then timed per turn
MIN_COSINE = 0.999                            # bf16 descriptors against f32 (the JAX suite's bound)
REMAT_RTOL, REMAT_ATOL = 1e-6, 1e-6           # REMAT against the plain step (the JAX suite's bounds)
# phase 11: ranks on the card, patch rows below B x (1 + P) = 12 (so they
# come from both ranks), the records of the sharded eval, timed calls, and
# the CPU suite's tolerances (tests/test_torch_parallel.py)
PARALLEL_RANKS = 2
PARALLEL_A2A = 8
PARALLEL_EVAL_BATCH = 100
PARALLEL_REPS = 3
PARALLEL_RTOL, PARALLEL_ATOL = 1e-5, 1e-5     # a step's total (relative) and parameters and statistics (absolute)
PARALLEL_DESC_TOL = 1e-5                      # sharded descriptors and features against the single-process forward
# a step's gradients against the single-process step's, leaf by leaf in
# relative L2, a leaf's norm floored at 1e-4 of the largest: the CPU
# suite's GRAD_RTOL (tests/test_torch_parallel.py, measured 2.4e-4 there
# on the point-sharded PPT-Net step); a dropped or mis-scaled leaf reads 1
PARALLEL_GRAD_RTOL = 1e-2


def say(*parts):
    print(*parts, flush=True)


def measured(label, text):
    """A line with a number, tagged with the card it was measured on."""
    say(f"[{CARD}] {label}: {text}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps, warmup=1):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fps_bound(b, n, m):
    """K1: the clouds read, the picks written; ten operations per point and step."""
    return bound(b * n * 12 + b * m * 4, b * (m - 1) * n * 10)


def knn_bound(b, n, m, k):
    """K2: candidates and queries read, k (index, d2) pairs written; ten operations per pair."""
    return bound(b * (n + m) * 12 + b * m * k * 8, b * m * n * 10)


def topk_bound(b, m, n, k):
    """K3: the matrix read, k (index, value) pairs written; a compare per element."""
    return bound(b * m * n * 4 + b * m * k * 8, b * m * n)


def price_bound(b, m, n):
    """K6: the base and the price read, k=2 (index, value) pairs written; an add and a compare per element."""
    return bound(b * m * n * 4 + b * n * 4 + b * m * 2 * 8, 2 * b * m * n)


def chunked_bound(chunk):
    """K4: the chunk read, k=2 (index, value) pairs written; a compare per element."""
    return bound(chunk.numel() * 4 + chunk.shape[1] * 2 * 8, chunk.numel())


def bn_relu_bound(rows, c):
    """The fused eval BatchNorm + ReLU: each element read once and written
    once (8 bytes); a subtraction, a product, a sum and a clamp each."""
    return bound(rows * c * 8, rows * c * 4)


def bf16_launches(launches):
    """An eval forward's launches at a bf16 compute dtype: its BatchNorm ->
    ReLU sites see bf16 and keep the two modules."""
    return {k: v for k, v in launches.items() if k != "bn_relu"}


def tail_bound(n, ids):
    """K6 on the active-set tail: the distinct base rows its ids name (the
    sentinel as row n - 1), the price and the ids read, k=2 (index,
    value) pairs written; an add and a compare per slot and column."""
    b, r = ids.shape
    flat = ids.clamp_max(n - 1) + n * ids.new_tensor(list(range(b)))[:, None]
    distinct = int(flat.unique().numel())
    return bound(distinct * n * 4 + b * n * 4 + b * r * 8 + b * r * 2 * 8, 2 * b * r * n)


def emd_sweep_inputs(torch, ops, gen):
    """K6's operands at the auction's shapes, drawn from ``gen``: the
    negated base of two (4, 4096, 3) clouds as the fused sweep forms it, a
    price row, and ``TAIL_ID_SETS`` sets of the active-set tail's (4, 256)
    row ids: per cloud ``EMD_TAIL_VALID`` distinct rows in ascending
    order, the rest of the 256 slots the padding sentinel n, as the
    auction packs them."""
    dev = gen.device
    x1 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    x2 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    neg_base = torch.sqrt(ops.pairwise_sqdist(x1, x2)) - 3.0
    price = torch.rand(EMD_B, EMD_N, generator=gen, device=dev) * 0.05
    id_sets = []
    for _ in range(TAIL_ID_SETS):
        ids = torch.full((EMD_B, EMD_TAIL_ROWS), EMD_N, dtype=torch.long, device=dev)
        for e, valid in enumerate(EMD_TAIL_VALID):
            ids[e, :valid] = torch.randperm(EMD_N, generator=gen, device=dev)[:valid].sort().values
        id_sets.append(ids)
    return neg_base, price, id_sets


def gather_rows(torch, base, ids):
    """The old route's gathered tail: the rows the ids name, the sentinel
    clamped to the last row, as a (b, r, n) copy."""
    batch = torch.arange(base.shape[0], device=base.device)[:, None]
    return base[batch, ids.clamp_max(base.shape[1] - 1)]


def queued_ms(torch, fn, reps):
    """Mean device time per call of ``fn(i)``, i = 0 .. reps - 1, back to
    back between two CUDA events. A sleep kernel holds the stream while the
    host queues the calls, so the host's cost per call does not show."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def chunked_input(torch, ops, gen):
    """K4's operand, drawn from ``gen``: the negated value of one 4096-row
    chunk of a row-chunked auction sweep at n=8192."""
    dev = gen.device
    c1 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    c2 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    cprice = torch.rand(1, CHUNKED_N, generator=gen, device=dev) * 0.05
    return -(3.0 - torch.sqrt(ops.pairwise_sqdist(c1[:, :4096], c2)) - cprice[:, None, :])


def level_clouds(torch, ops, fps, gen, batch=B, levels=PATCH_LEVELS):
    """A forward's point sets at ``batch``: random (batch, 4096, 3) clouds
    drawn from ``gen``, then the SA levels' FPS chain (``levels``:
    PatchAugNet's 1024, 128 and 16 centres, or PPT-Net's 1024, 256, 64 and
    16; ``fps`` is K1's wrapper or its plain version)."""
    x = [torch.rand(batch, N_POINTS, 3, generator=gen, device=gen.device)]
    for npoint in levels:
        x.append(ops.gather(x[-1], fps(x[-1], npoint)))
    return x


def knn_cases(x):
    """A forward's kNN launches as (label, candidates, queries, k): the SA
    levels' kNN (k=20, queries = the level's centres) and the FP levels'
    3-NN (queries = the finer level's points, candidates = the coarser
    level's)."""
    levels = range(len(x) - 1)
    return ([(f"SA{lv}", x[lv], x[lv + 1], 20) for lv in levels]
            + [(f"FP{lv}", x[lv + 1], x[lv], 3) for lv in levels])


def matrix_knn(ops, pts, qry, k):
    """The route the FP 3-NN took before K2 took it: form the (b, m, n)
    distance matrix, then K3."""
    return ops.topk_extract(ops.pairwise_sqdist(qry, pts), k)


def knn_yardsticks(torch, ops, pts, qry, k):
    """ms of ``torch.topk`` on the formed distance matrix, and of forming it."""
    dist = ops.pairwise_sqdist(qry, pts)
    lib = time_ms(torch, lambda: torch.topk(dist, k, dim=-1, largest=False), 10)
    form = time_ms(torch, lambda: ops.pairwise_sqdist(qry, pts), 10)
    return lib, form


class KernelRecord:
    def __init__(self, name, module, source, replaces, counter="launches"):
        self.name, self.module, self.source, self.replaces = name, module, source, replaces
        self.counter = counter   # the wrapper's launch count in ``module``
        self.cases = []          # (ms, plain_ms, library_ms, bound_ms, bound_by)
        self.max_abs_err = 0.0

    def as_json(self, launches):
        ms = sum(c[0] for c in self.cases)
        lib = [c[2] for c in self.cases]
        widest = max(self.cases, key=lambda c: c[3])
        return {
            "name": self.name, "route": "cuda", "source": self.source, "replaces": self.replaces,
            "launches": launches, "max_abs_err": self.max_abs_err, "ms": ms,
            "plain_ms": sum(c[1] for c in self.cases),
            "bound_ms": sum(c[3] for c in self.cases), "bound_by": widest[4],
            "library_ms": None if None in lib else sum(lib),
        }


def reset_counts(mods, records):
    for rec in records:
        setattr(mods[rec.module], rec.counter, 0)


def read_counts(mods, records):
    return {rec.name: getattr(mods[rec.module], rec.counter) for rec in records}


def _bn_then_relu(bn, x):
    """``BatchNorm.relu``'s plain version: the module, then ``torch.relu``."""
    import torch

    return torch.relu(bn(x))


@contextlib.contextmanager
def plain_kernels(mods):
    """Route every kernel wrapper to its plain torch version (for the
    on-card reference run); restores the kernels on exit. K4's card path
    takes no chunk count, so its stand-in is the flat plain extraction, the
    same function (phase 2 holds K4 against its two-level plain version).
    The fused eval BatchNorm + ReLU is registered with the dispatcher
    directly, so ``BatchNorm.relu`` itself takes the two modules instead."""
    from patchaugnet_tpu_torch.nn import BatchNorm

    fps, knn, topk = mods["fps"], mods["knn"], mods["topk"]
    swaps = [(BatchNorm, "relu", _bn_then_relu),
             (fps, "_fps_cuda", fps._farthest_point_sample_torch),
             (knn, "_knn_cuda", knn._knn_torch),
             (topk, "_topk_extract_cuda", topk._topk_extract_torch),
             (topk, "_topk_extract_price_cuda", topk._topk_extract_price_torch),
             (topk, "_topk_extract_chunked_cuda", topk._topk_extract_torch)]
    saved = [getattr(owner, name) for owner, name, _ in swaps]
    for owner, name, plain in swaps:
        setattr(owner, name, plain)
    try:
        yield
    finally:
        for (owner, name, _), fn in zip(swaps, saved):
            setattr(owner, name, fn)


def phase_build(cuda):
    t0 = time.perf_counter()
    logs = cuda.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if ("ptxas" in line and ("Used" in line or "Compiling" in line)) or "spill" in line:
                say(f"  {name}: {line.strip()}")
    spills = [line.strip() for line in logs["fps"].splitlines()
              if any(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))]
    if spills:
        raise AssertionError(f"ptxas spills registers in the fps kernels: {spills}")
    say(f"build: {len(logs)} libraries ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc sm_90a, into {cuda.BUILD_DIR})")


def phase_kernels(torch, ops, mods, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = level_clouds(torch, ops, mods["fps"]._farthest_point_sample_torch, gen)

    k1 = KernelRecord("fps", "fps", "patchaugnet_tpu_torch/csrc/fps.cu", "patchaugnet_tpu/ops/pallas/fps.py:64")
    for level in range(3):
        pts, m = x[level], x[level + 1].shape[1]
        n = pts.shape[1]
        got = ops.farthest_point_sample(pts, m)
        want = mods["fps"]._farthest_point_sample_torch(pts, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fps SA{level}: kernel indices differ from the plain version")
        ms = time_ms(torch, lambda: ops.farthest_point_sample(pts, m), 20)
        plain = time_ms(torch, lambda: mods["fps"]._farthest_point_sample_torch(pts, m), 2)
        b_ms, b_by = fps_bound(B, n, m)
        k1.cases.append((ms, plain, None, b_ms, b_by))
        measured(f"K1 fps SA{level} (b,n,m)=({B},{n},{m})",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), indices equal")
    check_fps_layouts(torch, ops, mods["fps"], x, torch.Generator(device=dev).manual_seed(6))
    same = torch.ones(B, N_POINTS, 3, device=dev)

    k2 = KernelRecord("knn", "knn", "patchaugnet_tpu_torch/csrc/knn.cu", "patchaugnet_tpu/ops/pallas/knn.py:96")
    knn = mods["knn"]
    for label, pts, qry, k in knn_cases(x):
        n, m = pts.shape[1], qry.shape[1]
        tied = (pts * 8).floor() / 8                           # coarse grid: many equal distances
        tied[:, 1::7] = tied[:, :1]                            # and duplicated points
        for what, cand in (("random", pts), ("tied", tied)):
            check_equal(torch, f"knn {label} {what} cloud", ops.knn(cand, qry, k),
                        knn._knn_torch(cand, qry, k))
        ms = time_ms(torch, lambda: ops.knn(pts, qry, k), 20)
        plain = time_ms(torch, lambda: knn._knn_torch(pts, qry, k), 3)
        lib, pair_ms = knn_yardsticks(torch, ops, pts, qry, k)
        b_ms, b_by = knn_bound(B, n, m, k)
        k2.cases.append((ms, plain, lib, b_ms, b_by))
        lanes = knn.lanes_for(B, n, m, k, mods["cuda"].sm_count(dev))
        text = (f"kernel {ms:.4f} ms ({lanes} lanes per query), plain {plain:.4f} ms, torch.topk on the "
                f"distance matrix {lib:.4f} ms (+{pair_ms:.4f} ms to form it)")
        if label.startswith("FP"):
            old = time_ms(torch, lambda: matrix_knn(ops, pts, qry, k), 20)
            for what, cand in (("random", pts), ("tied", tied), ("all-equal", torch.ones_like(pts))):
                got = ops.three_nn(qry, cand)
                ref = matrix_knn(ops, cand, qry, k)
                check_equal(torch, f"three_nn {label} {what} cloud", (got[1], got[0]),
                            (ref[0], torch.sqrt(ref[1])))
            text += f", the matrix and K3 {old:.4f} ms"
        measured(f"K2 knn {label} (b,n,m,k)=({B},{n},{m},{k})",
                 f"{text}, bound {b_ms:.4f} ms ({b_by}), indices and d2 equal (random and tied clouds)")
        if label.startswith("FP"):
            say(f"K2 three_nn {label}: equal to the matrix and K3 bit for bit on random, tied and "
                f"all-equal clouds")
    for k in (3, 20):
        gi, gd = ops.knn(same, same[:, :64], k)
        if not torch.equal(gi, torch.arange(k, dtype=torch.int32, device=dev).expand(B, 64, k)) or gd.any():
            raise AssertionError(f"knn: an all-equal cloud must return indices 0..k-1 at k={k}")
    say("K2 knn: all-equal cloud returns indices 0..k-1 and d2 0 at k=3 and k=20")

    k3 = KernelRecord("topk_extract", "topk", "patchaugnet_tpu_torch/csrc/topk.cu",
                      "patchaugnet_tpu/ops/pallas/knn.py:201")
    for level in range(3):                                 # off the forward since K2 took the FP 3-NN
        unknown, known, k = x[level], x[level + 1], 3
        dist = ops.pairwise_sqdist(unknown, known)          # (B, m, n) as three_nn formed it
        m, n = dist.shape[1], dist.shape[2]
        gi, gv = ops.topk_extract(dist, k)
        ri, rv = mods["topk"]._topk_extract_torch(dist, k)
        torch.cuda.synchronize()
        err = (gv - rv).abs().max().item()
        if not torch.equal(gi, ri) or err > 1e-6:
            raise AssertionError(f"topk FP{level}: kernel differs from the plain version (err {err})")
        for s in mods["topk"].WARPS:
            got = mods["topk"]._topk_extract_cuda(dist, k, warps=s)
            check_equal(torch, f"topk FP{level} at {s} warps per row", got, (ri, rv))
        k3.max_abs_err = max(k3.max_abs_err, err)
        ms = time_ms(torch, lambda: ops.topk_extract(dist, k), 20)
        plain = time_ms(torch, lambda: mods["topk"]._topk_extract_torch(dist, k), 3)
        lib = time_ms(torch, lambda: torch.topk(dist, k, dim=-1, largest=False), 10)
        del dist
        b_ms, b_by = topk_bound(B, m, n, k)
        k3.cases.append((ms, plain, lib, b_ms, b_by))
        measured(f"K3 topk_extract FP{level} (b,m,n,k)=({B},{m},{n},{k})",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.topk {lib:.4f} ms, "
                 f"bound {b_ms:.4f} ms ({b_by}), indices equal, value max abs err {err:.3g}")
    tied = torch.randint(0, 4, (B, 1024, 128), generator=gen, device=dev).float()
    for k in (3, 20):
        if not all(torch.equal(a, b) for a, b in zip(ops.topk_extract(tied, k),
                                                     mods["topk"]._topk_extract_torch(tied, k))):
            raise AssertionError(f"topk: tied matrix differs from the plain version at k={k}")
    say("K3 topk_extract: tied matrix (values in {0,1,2,3}) matches the plain version at k=3 and k=20")
    return [k1, k2, k3, check_bn_relu(torch, ops, mods["norm"], dev)]


def check_bn_relu(torch, ops, norm, dev):
    """The fused eval BatchNorm + ReLU (``ops.bn_relu``) bit-equal to its
    plain version, the four torch passes, at ``BN_RELU_CASES`` (float4
    path) and on the scalar path (a C of 3, an input 4 bytes off
    alignment), NaN and infinities passed through; timed beside the plain
    version at ``BN_RELU_CASES``. Returns its record."""
    rec = KernelRecord("bn_relu", "norm", "patchaugnet_tpu_torch/csrc/bn_relu.cu",
                       "patchaugnet_tpu_torch/nn/core.py (eval BatchNorm, then torch.relu)")
    gen = torch.Generator(device=dev).manual_seed(8)

    def operands(rows, c):
        x = torch.randn(rows, c, generator=gen, device=dev) * 3
        x.view(-1)[:5] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0], device=dev)
        mean, bias = (torch.randn(c, generator=gen, device=dev) * 0.1 for _ in range(2))
        return x, mean, torch.rand(c, generator=gen, device=dev) + 0.5, bias

    def check(what, x, *vectors):
        got, want = ops.bn_relu(x, *vectors), norm._bn_relu_plain(x, *vectors)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"bn_relu {what}: the kernel differs from the four passes")

    x, mean, mul, bias = operands(1001, 3)
    check("(1001, 3)", x, mean, mul, bias)
    flat = torch.randn(1 + 1000 * 64, generator=gen, device=dev)
    _, mean, mul, bias = operands(1, 64)
    check("(1000, 64) 4 bytes off alignment", flat[1:].view(1000, 64), mean, mul, bias)
    for label, rows, c in BN_RELU_CASES:
        x, mean, mul, bias = operands(rows, c)
        check(f"{label} ({rows}, {c})", x, mean, mul, bias)
        ms = time_ms(torch, lambda: ops.bn_relu(x, mean, mul, bias), 20)
        plain = time_ms(torch, lambda: norm._bn_relu_plain(x, mean, mul, bias), 5)
        b_ms, b_by = bn_relu_bound(rows, c)
        rec.cases.append((ms, plain, None, b_ms, b_by))
        measured(f"pan::bn_relu {label} (rows, C)=({rows},{c}), B=100",
                 f"kernel {ms:.4f} ms, the four passes {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                 f"{b_ms / ms:.1%} of it; bit-equal (NaN and infinities included)")
        del x
    say("pan::bn_relu: bit-equal to the four passes on the scalar path (C=3; an input 4 bytes off alignment)")
    return rec


def check_fps_layouts(torch, ops, fps, x, gen):
    """K1 bit-equal to its plain version at the three SA levels at B=32
    (``x``) and B=100 (clouds drawn from ``gen``), on random,
    duplicated-grid and all-equal clouds, at every layout the kernel is
    built for that holds the level's n (the layout rule picks among them)
    and through the wrapper's own pick."""
    for clouds in (x, level_clouds(torch, ops, fps._farthest_point_sample_torch, gen, 100)):
        batch = clouds[0].shape[0]
        for level in range(3):
            pts, m = clouds[level], clouds[level + 1].shape[1]
            n = pts.shape[1]
            tied = (pts * 8).floor() / 8                       # coarse grid: many equal distances
            tied[:, 1::7] = tied[:, :1]                        # and duplicated points
            layouts = [lay for lay in fps.LAYOUTS if lay[0] * lay[1] >= n or lay == fps.SCRATCH]
            for what, cloud in (("random", pts), ("duplicated-grid", tied), ("all-equal", torch.ones_like(pts))):
                want = fps._farthest_point_sample_torch(cloud, m)
                if what == "all-equal" and want.any():
                    raise AssertionError("fps: the plain version must pick index 0 throughout an all-equal cloud")
                runs = [("rule", ops.farthest_point_sample(cloud, m))]
                runs += [(lay, fps._fps_cuda(cloud, m, layout=lay)) for lay in layouts]
                torch.cuda.synchronize()
                for lay, got in runs:
                    if not torch.equal(got, want):
                        raise AssertionError(f"fps SA{level} B={batch} {what} cloud, layout {lay}: kernel "
                                             f"indices differ from the plain version")
            say(f"K1 fps SA{level} B={batch}: bit-equal to the plain version on random, duplicated-grid and "
                f"all-equal clouds at layouts {layouts} (the rule picks {fps.layout_for(n)})")


def check_equal(torch, what, got, want):
    """Indices and values exactly equal (K3-K6 round nothing differently
    from their plain versions)."""
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        err = (got[1] - want[1]).abs().max().item()
        raise AssertionError(f"{what}: kernel differs from the plain version (value err {err})")


def phase_emd_kernels(torch, ops, mods, dev):
    """K4-K6 at the auction's shapes, against their plain versions."""
    topk = mods["topk"]
    sms = mods["cuda"].sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    neg_base, price, id_sets = emd_sweep_inputs(torch, ops, gen)
    ids = id_sets[0]
    b, n = price.shape
    r = ids.shape[1]

    k6 = KernelRecord("topk_extract_price", "topk", "patchaugnet_tpu_torch/csrc/topk.cu",
                      "patchaugnet_tpu/ops/pallas/knn.py:286", counter="price_launches")
    check_equal(torch, "K6 full sweep", ops.topk_extract_price(neg_base, price, 2),
                topk._topk_extract_price_torch(neg_base, price, 2))
    ms = time_ms(torch, lambda: ops.topk_extract_price(neg_base, price, 2), 20)
    plain = time_ms(torch, lambda: topk._topk_extract_price_torch(neg_base, price, 2), 3)
    summed = neg_base + price[:, None, :]
    lib = time_ms(torch, lambda: torch.topk(summed, 2, dim=-1, largest=False), 10)
    add_ms = time_ms(torch, lambda: neg_base + price[:, None, :], 10)
    del summed
    b_ms, b_by = price_bound(b, n, n)
    k6.cases.append((ms, plain, lib, b_ms, b_by))
    measured(f"K6 topk_extract_price full sweep (b,m,n,k)=({b},{n},{n},2), "
             f"{topk.warps_for(b * n, n, sms)} warps per row",
             f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.topk on the sum {lib:.4f} ms "
             f"(+{add_ms:.4f} ms to form it), bound {b_ms:.4f} ms ({b_by}), indices and values equal")

    # the active-set tail read through the ids from the full base, beside
    # the old route on the same ids; timed cold in L2, the id sets in turn
    want = topk._topk_extract_price_torch(neg_base, price, 2, ids)
    check_equal(torch, "K6 active-set tail", ops.topk_extract_price(neg_base, price, 2, ids), want)
    for s in topk.WARPS:
        check_equal(torch, f"K6 active-set tail at {s} warps per row",
                    topk._topk_extract_price_cuda(neg_base, price, 2, ids, warps=s), want)
    check_equal(torch, "the old tail route", topk._topk_extract_price_cuda(gather_rows(torch, neg_base, ids),
                                                                          price, 2, warps=1), want)
    turn = TAIL_ID_SETS * 8
    rotate = iter(range(1 << 30))
    ms = time_ms(torch, lambda: ops.topk_extract_price(neg_base, price, 2, id_sets[next(rotate) % TAIL_ID_SETS]),
                 turn)
    queued = queued_ms(torch, lambda i: ops.topk_extract_price(neg_base, price, 2, id_sets[i % TAIL_ID_SETS]),
                       turn)
    old = queued_ms(torch, lambda i: topk._topk_extract_price_cuda(
        gather_rows(torch, neg_base, id_sets[i % TAIL_ID_SETS]), price, 2, warps=1), turn)
    gather_ms = queued_ms(torch, lambda i: gather_rows(torch, neg_base, id_sets[i % TAIL_ID_SETS]), turn)
    plain = time_ms(torch, lambda: topk._topk_extract_price_torch(neg_base, price, 2, ids), 3)
    summed = gather_rows(torch, neg_base, ids) + price[:, None, :]
    lib = time_ms(torch, lambda: torch.topk(summed, 2, dim=-1, largest=False), 10)
    form_ms = time_ms(torch, lambda: gather_rows(torch, neg_base, ids) + price[:, None, :], 10)
    del summed
    b_ms, b_by = tail_bound(n, ids)
    k6.cases.append((ms, plain, lib, b_ms, b_by))
    measured(f"K6 topk_extract_price active-set tail (b,r,n,k)=({b},{r},{n},2), {EMD_TAIL_VALID} valid slots, "
             f"{topk.warps_for(b * r, n, sms)} warps per row",
             f"kernel through the ids {ms:.4f} ms per call (the wrapper's host cost included), device "
             f"{queued:.4f} ms per call against the old route (gather, then K6 at 1 warp per row) {old:.4f} "
             f"ms (the gather alone {gather_ms:.4f} ms), both queued back to back behind a sleep kernel, "
             f"every call cold in L2 (the id sets in turn); plain {plain:.4f} ms, torch.topk on the "
             f"gathered sum {lib:.4f} ms (+{form_ms:.4f} ms to gather and add), bound {b_ms:.4f} ms ({b_by}), "
             f"indices and values equal in every slot, padding included, at every warps count")
    for k in (3, 8, 32):
        check_equal(torch, f"K6 generic k={k}", ops.topk_extract_price(neg_base, price, k, ids),
                    topk._topk_extract_price_torch(neg_base, price, k, ids))
    ms8 = time_ms(torch, lambda: ops.topk_extract_price(neg_base, price, 8, ids), 20)
    measured(f"K6 generic k=8 on the tail ({b},{r},{n})", f"kernel {ms8:.4f} ms (warm)")
    tied_base = torch.randint(0, 4, (EMD_B, EMD_TAIL_ROWS, EMD_N), generator=gen, device=dev).float()
    tied_price = torch.randint(0, 3, (EMD_B, EMD_N), generator=gen, device=dev).float() * 0.5
    tied_ids = ids.clamp_max(EMD_TAIL_ROWS)                 # rows of tied_base, the sentinel included
    for k in (2, 20):
        check_equal(torch, f"K6 tied k={k}", ops.topk_extract_price(tied_base, tied_price, k),
                    topk._topk_extract_price_torch(tied_base, tied_price, k))
        check_equal(torch, f"K6 tied through ids k={k}", ops.topk_extract_price(tied_base, tied_price, k, tied_ids),
                    topk._topk_extract_price_torch(tied_base, tied_price, k, tied_ids))
    say("K6 topk_extract_price: generic k=3/8/32 and tied base and price (k=2, 20; rows in order and "
        "through ids) equal the plain version")

    k4 = KernelRecord("topk_extract_chunked", "topk", "patchaugnet_tpu_torch/csrc/topk.cu",
                      "patchaugnet_tpu/ops/pallas/knn.py:330", counter="chunked_launches")
    chunk = chunked_input(torch, ops, gen)
    before = topk.chunked_launches
    got = ops.topk_extract_chunked(chunk, 2)
    if topk.chunked_launches != before + 1:
        raise AssertionError("K4: expected one launch per call")
    check_equal(torch, "K4 vs flat K3", got, ops.topk_extract(chunk, 2))
    check_equal(torch, "K4 vs its two-level plain version", got, topk._topk_extract_chunked_torch(chunk, 2, 64))
    check_equal(torch, "K4 vs plain", got, topk._topk_extract_torch(chunk, 2))
    for s in topk.WARPS:
        check_equal(torch, f"K4 chunk at {s} warps per row", topk._topk_extract_cuda(chunk, 2, warps=s), got)
    ms = time_ms(torch, lambda: ops.topk_extract_chunked(chunk, 2), 20)
    plain = time_ms(torch, lambda: topk._topk_extract_chunked_torch(chunk, 2, 64), 3)
    flat = time_ms(torch, lambda: ops.topk_extract(chunk, 2), 20)
    flat1 = time_ms(torch, lambda: topk._topk_extract_cuda(chunk, 2, warps=1), 20)
    lib = time_ms(torch, lambda: torch.topk(chunk, 2, dim=-1, largest=False), 10)
    b_ms, b_by = chunked_bound(chunk)
    k4.cases.append((ms, plain, lib, b_ms, b_by))
    measured(f"K4 topk_extract_chunked (b,m,n,k)=(1,4096,{CHUNKED_N},2), 64 chunks, "
             f"{topk.warps_for(chunk.shape[1], CHUNKED_N, sms)} warps per row",
             f"one launch {ms:.4f} ms, flat K3 {flat:.4f} ms ({flat1:.4f} ms at 1 warp per row), plain "
             f"{plain:.4f} ms, torch.topk {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), equal to flat K3, to "
             f"the two-level and the flat plain versions, and at every warps count")
    del chunk

    del neg_base
    return [k4, k6]


def check_provenance(torch, ref, plain, family, what):
    """The provenance indices of ``family``'s outputs (``PROVENANCE``; a
    family without any, none) equal on the kernel path (``ref``) and the
    plain path, level by level."""
    for name in PROVENANCE.get(family, ()):
        for level, (a, b) in enumerate(zip(getattr(ref, name), getattr(plain, name), strict=True)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name}[{level}] of the kernel path differs from the plain path")


def check_against_plain(torch, mods, records, model, clouds, family, what):
    """``model`` (of ``family``) in eval mode on ``clouds`` through the
    kernels and through their plain versions: provenance indices equal,
    global descriptors within 1e-5. The model's mode is restored. Returns
    the kernels' global descriptors and their max abs error."""
    training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            ref = model(clouds)
            with plain_kernels(mods):
                before = read_counts(mods, records)
                plain = model(clouds)
                if read_counts(mods, records) != before:
                    raise AssertionError(f"{what}: the plain run launched a kernel")
    finally:
        model.train(training)
    from patchaugnet_tpu_torch import serving

    check_provenance(torch, ref, plain, family, what)
    ref, plain = serving.global_desc(ref), serving.global_desc(plain)
    desc_err = (ref - plain).abs().max().item()
    if desc_err > 1e-5:
        raise AssertionError(f"{what}: descriptors differ from the plain path's by {desc_err}")
    return ref, desc_err


def phase_serving(torch, mods, records, dev):
    """The full-width PatchAugNet served (``serve``), its descriptors unit-norm."""
    from patchaugnet_tpu_torch import configs
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    model = seeded_init_(get_model("patch_aug_net", configs.PATCH_AUG_NET), torch.Generator().manual_seed(0))
    counts, _, descs = serve(torch, mods, records, dev, model, "patch_aug_net", FORWARD_LAUNCHES, seed=1)
    norm_err = max((d.norm(dim=-1) - 1).abs().max().item() for d in descs)
    if norm_err > 1e-5:
        raise AssertionError(f"descriptors not unit-norm (max |norm - 1| = {norm_err})")
    return counts


def serve(torch, mods, records, dev, model, what, launches, seed):
    """``model`` through ``serving.build_forward_fn``: ``REQUESTS`` requests
    of B clouds drawn from ``seed``, with ``launches`` kernel launches per
    forward and no other, finite (B, 256) descriptors equal to the direct
    forward's, and, where the path launches kernels, the same model through
    the plain versions (provenance indices equal, descriptors within 1e-5);
    then descriptors/s at B=32 and B=100 and the peak device memory.
    Returns the launch counts, the first request's clouds and the served
    descriptors."""
    from patchaugnet_tpu_torch import serving

    forward = serving.build_forward_fn(model, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    requests = [torch.rand(B, N_POINTS, 3, generator=gen, device=dev) for _ in range(REQUESTS)]
    forward(requests[0])                                  # warm-up
    torch.cuda.synchronize()
    reset_counts(mods, records)
    t0 = time.perf_counter()
    descs = [forward(x) for x in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(mods, records)
    check_launches(counts, {k: v * REQUESTS for k, v in launches.items()}, f"{what} serving")
    for d in descs:
        if d.shape != (B, 256) or not torch.isfinite(d).all():
            raise AssertionError(f"{what}: descriptor batch {tuple(d.shape)} not finite (B, 256)")
    if launches:
        direct, desc_err = check_against_plain(torch, mods, records, model, requests[0], what,
                                               f"{what} serving B={B}")
        text = f"provenance indices equal to the plain path, descriptor max abs err {desc_err:.3g} (plain)"
    else:
        model.eval()
        with torch.inference_mode():
            direct = serving.global_desc(model(requests[0]))
        text = "no kernel on this path"
    served_err = (direct - descs[0]).abs().max().item()
    if served_err > 1e-5:
        raise AssertionError(f"{what}: served descriptors differ from the direct forward's by {served_err}")
    measured(f"{what} serving {REQUESTS} requests of {B} x {N_POINTS} points",
             f"{wall * 1e3:.2f} ms, kernel launches {counts}; {text}; {served_err:.3g} (served vs direct)")
    for batch, iters in THROUGHPUT_BATCHES:
        clouds = torch.rand(batch, N_POINTS, 3, generator=gen, device=dev)
        forward(clouds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = forward(clouds)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / iters
        if not torch.isfinite(out).all():
            raise AssertionError(f"{what} B={batch}: non-finite descriptors")
        measured(f"{what} throughput B={batch}",
                 f"{batch / sec:.1f} descriptors/s ({sec * 1e3:.2f} ms per batch, {iters} batches), peak memory "
                 f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return counts, requests[0], descs


def check_launches(counts, want, what):
    for name, count in counts.items():
        if count != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {count} times, expected {want.get(name, 0)}")


def phase_emd(torch, ops, mods, records, dev):
    """The reconstruction-loss path: ``emd_loss`` at the reference call site."""
    from patchaugnet_tpu_torch import losses

    emd = mods["emd"]
    gen = torch.Generator(device=dev).manual_seed(4)
    pc1 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    pc2 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    ops.auction_emd(pc1, pc2, EMD_EPS, 8)                   # warm-up
    torch.cuda.synchronize()

    x = pc1.clone().requires_grad_()
    reset_counts(mods, records)
    t0 = time.perf_counter()
    loss = losses.emd_loss(x, pc2, EMD_EPS, EMD_ITERS)
    loss.backward()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(mods, records)
    iters, unass = emd.iterations, emd.unassigned
    check_launches(counts, {"topk_extract_price": iters + 1}, "emd_loss")
    if not (torch.isfinite(loss) and torch.isfinite(x.grad).all()) or x.grad.shape != pc1.shape:
        raise AssertionError("emd_loss: non-finite loss or gradient")
    # every launch at most as long as a full-width sweep (phase 2's time;
    # the active-set tail's are shorter)
    k6_full_ms = next(r for r in records if r.name == "topk_extract_price").cases[0][0]
    k6_share = counts["topk_extract_price"] * k6_full_ms / call_ms
    measured(f"emd_loss forward+backward ({EMD_B},{EMD_N},3) eps={EMD_EPS} iters={EMD_ITERS}",
             f"{call_ms:.3f} ms per call, {iters} iterations ({call_ms / iters:.4f} ms per iteration), "
             f"{unass} rows unassigned at exit, loss {loss.item():.6f}, K6 launches {counts['topk_extract_price']}, "
             f"K6 at most {k6_share:.1%} of the call")

    dist, assignment = ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS)
    with plain_kernels(mods):
        before = read_counts(mods, records)
        plain_dist, plain_assignment = ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS)
        if read_counts(mods, records) != before:
            raise AssertionError("the plain auction launched a kernel")
    if not (torch.equal(assignment, plain_assignment) and torch.equal(dist, plain_dist)):
        raise AssertionError("auction: the kernel path's assignment differs from the plain path's")
    unique = min(int(a.unique().numel()) for a in assignment)
    say(f"EMD: assignment and distances equal to the plain-kernel run on the card; "
        f"min unique assignments per cloud {unique}/{EMD_N}, mean sqdist {dist.mean().item():.6f}")

    for label, kw in (("unass_floor=41", {"unass_floor": 41}),
                      ("eps_schedule=(10, 1)", {"eps_schedule": (10.0, 1.0)})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist, assignment = ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        unique = min(int(a.unique().numel()) for a in assignment)
        measured(f"auction_emd forward, {label}",
                 f"{ms:.3f} ms, {emd.iterations} iterations, {emd.unassigned} unassigned at exit, "
                 f"min unique {unique}/{EMD_N}, mean sqdist {dist.mean().item():.6f}")

    # a row-chunked auction (two 4096-row chunks of 8192 columns): each
    # chunk's top-2 is too wide for the TPU's flat tile, so it runs K4
    c1 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    c2 = torch.rand(1, CHUNKED_N, 3, generator=gen, device=dev)
    saved = os.environ.get("PCR_EMD_SWEEP")
    os.environ["PCR_EMD_SWEEP"] = "chunked"
    try:
        reset_counts(mods, records)
        t0 = time.perf_counter()
        dist, assignment = ops.auction_emd(c1, c2, EMD_EPS, CHUNKED_ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        chunked_counts = read_counts(mods, records)
        sweeps = emd.iterations + 1
        # two K4 calls per sweep (one per 4096-row chunk), one launch each
        check_launches(chunked_counts, {"topk_extract_chunked": 2 * sweeps}, "row-chunked auction")
        with plain_kernels(mods):
            plain_dist, plain_assignment = ops.auction_emd(c1, c2, EMD_EPS, CHUNKED_ITERS)
    finally:
        if saved is None:
            del os.environ["PCR_EMD_SWEEP"]
        else:
            os.environ["PCR_EMD_SWEEP"] = saved
    if not (torch.equal(assignment, plain_assignment) and torch.equal(dist, plain_dist)):
        raise AssertionError("row-chunked auction: the kernel path differs from the plain path")
    measured(f"row-chunked auction (1,{CHUNKED_N},3), {CHUNKED_ITERS} iterations",
             f"{ms:.3f} ms, K4 kernel launches {chunked_counts['topk_extract_chunked']}, "
             f"assignment equal to the plain-kernel run")
    return counts, chunked_counts


def train_batch(torch, cfg, dev, seed):
    """One tuple batch for ``cfg`` drawn from a numpy generator: (B*T, N, 3)
    uniform clouds, the mask of the query and positive clouds, and
    correspondence tables of ``A2B_MAX_ROWS`` rows over the (query,
    positive) pairs with patch slots in [0, SAMPLING[0]), about half the
    rows valid and the last pair with none; for a model without a patch
    branch the empty tables and an all-false mask."""
    import numpy as np
    from patchaugnet_tpu_torch.losses import PatchCorrespondences
    from patchaugnet_tpu_torch.train import empty_patch_inputs

    rng = np.random.default_rng(seed)
    b, p = cfg["TRAIN_BATCH_SIZE"], cfg["TRAIN_POSITIVES_PER_QUERY"]
    t = 1 + p + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 1
    clouds = torch.from_numpy(rng.random((b * t, cfg["NUM_POINTS"], 3), dtype=np.float32)).to(dev)
    if cfg["model_type"] != "patch_aug_net":               # no patch branch: empty tables
        corr, mask = empty_patch_inputs(cfg, b * t)
        return clouds, mask.to(dev), corr.to(dev)
    mask = np.zeros(b * t, bool)
    for q in range(b):
        mask[q * t: q * t + 1 + p] = True
    rows, pairs = cfg["A2B_MAX_ROWS"], b * p
    pair = rng.integers(0, pairs, rows, dtype=np.int32)
    q_cloud = (t * (pair // p)).astype(np.int32)
    n_cloud = (q_cloud + 1 + pair % p).astype(np.int32)
    slots = [rng.integers(0, cfg["SAMPLING"][0], rows, dtype=np.int32) for _ in range(3)]
    valid = (rng.random(rows) < 0.5) & (pair != pairs - 1)
    corr = PatchCorrespondences(*(torch.from_numpy(a).to(dev) for a in (q_cloud, n_cloud, *slots, pair, valid)),
                                cfg["A2B_MAX_PAIRS"])
    return clouds, torch.from_numpy(mask).to(dev), corr


def check_level_shapes(torch, mods, dev, batch, what, levels=PATCH_LEVELS, tied=False):
    """K1 at the SA levels and K2 at the kNN cases of a forward on
    ``batch`` clouds (``levels``: the model's SA centres), bit-equal to
    their plain versions (the lanes rule takes the batch: PatchAugNet's SA1
    runs 32 lanes per query at 32 clouds, 16 at 36 and 8 at 72 and 100);
    with ``tied``, on duplicated-grid clouds too (many equal distances)."""
    from patchaugnet_tpu_torch import ops

    fps, knn = mods["fps"], mods["knn"]
    x = level_clouds(torch, ops, fps._farthest_point_sample_torch, torch.Generator(device=dev).manual_seed(7), batch,
                     levels)
    kinds = [("random", x)]
    if tied:
        grid = [(c * 8).floor() / 8 for c in x]
        for c in grid:
            c[:, 1::7] = c[:, :1]
        kinds.append(("duplicated-grid", grid))
    lanes, layouts = [], []
    for kind, clouds in kinds:
        for level in range(len(levels)):
            m = clouds[level + 1].shape[1]
            if not torch.equal(ops.farthest_point_sample(clouds[level], m),
                               fps._farthest_point_sample_torch(clouds[level], m)):
                raise AssertionError(f"fps SA{level} B={batch} {kind}: kernel indices differ from the plain version")
            if kind == "random":
                layouts.append(f"SA{level} {fps.layout_for(clouds[level].shape[1])}")
        for label, pts, qry, k in knn_cases(clouds):
            check_equal(torch, f"knn {label} B={batch} {kind}", ops.knn(pts, qry, k), knn._knn_torch(pts, qry, k))
            if kind == "random":
                lanes.append(f"{label} {knn.lanes_for(batch, pts.shape[1], qry.shape[1], k, mods['cuda'].sm_count(dev))}")
    say(f"K1 and K2 at {what} B={batch}: bit-equal to the plain versions at the {len(levels)} SA levels "
        f"and the {2 * len(levels)} kNN cases on {' and '.join(k for k, _ in kinds)} clouds (K1 layouts: "
        f"{', '.join(layouts)}; K2 lanes per query: {', '.join(lanes)})")


def phase_train(torch, mods, records, dev):
    """The flagship train step at full width through the port's entry
    points: its centres (``build_center_fn``, one K1 launch, equal to the
    forward's level-1 centres), then ``train_model``."""
    from patchaugnet_tpu_torch import configs, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    cfg = configs.PATCH_AUG_NET_TRAIN
    check_level_shapes(torch, mods, dev, cfg["TRAIN_BATCH_SIZE"] * (cfg["TRAIN_POSITIVES_PER_QUERY"]
                                                                   + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 2),
                       "the train step's batch")
    clouds, _, _ = train_batch(torch, cfg, dev, seed=6)
    reset_counts(mods, records)
    centers = train.build_center_fn(cfg["SAMPLING"][0], device=dev)(clouds)
    torch.cuda.synchronize()
    center_counts = read_counts(mods, records)
    check_launches(center_counts, CENTER_LAUNCHES, "build_center_fn")
    model = seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(5))
    step_counts, step_ms, origin = train_model(torch, mods, records, dev, cfg, model, "patch_aug_net", STEP_LAUNCHES,
                                               seed=6)
    if not torch.equal(centers, origin[0]):
        raise AssertionError("build_center_fn: centres differ from the forward's level-1 centres")
    say(f"train: centres equal to the forward's, launches {center_counts}")
    # the patch branch on A2A_MAX_CLOUDS = 8 of the 12 query and positive
    # clouds, against the plain kernels' path from a deep copy
    a2a = dict(cfg, A2A_MAX_CLOUDS=PARALLEL_A2A)
    model = seeded_init_(get_model("patch_aug_net", a2a), torch.Generator().manual_seed(5))
    a2a_counts, _, _ = train_model(torch, mods, records, dev, a2a, model, f"patch_aug_net (A2A_MAX_CLOUDS={PARALLEL_A2A})",
                                   STEP_LAUNCHES, seed=6, timed_steps=False)
    return center_counts, step_counts, step_ms, a2a_counts


def train_model(torch, mods, records, dev, cfg, model, what, launches, seed, timed_steps=True):
    """One step of ``train.build_train_step`` on ``cfg``'s tuple batch
    (``train_batch`` from ``seed``: clouds of 4096 points, and for
    PatchAugNet the patch branch on the query and positive clouds and
    seeded correspondence tables), with ``launches`` kernel launches and no
    other; where the path launches kernels, held against the same step
    from a deep copy of the state on the plain versions (provenance
    indices equal, metrics and new BatchNorm statistics within 1e-6);
    every loss term finite and positive, parameters changed and finite,
    every statistic changed; then ms per step, clouds/s and peak memory
    over TRAIN_STEPS steps after TRAIN_WARMUP (not without
    ``timed_steps``). Returns the launch counts, the ms per step (None
    untimed) and the first step's provenance centres (None for a model
    without them)."""
    from patchaugnet_tpu_torch import train

    state = train.create_train_state(model, cfg, device=dev)
    plain_state = copy.deepcopy(state) if launches else None
    clouds, mask, corr = train_batch(torch, cfg, dev, seed=seed)
    total = clouds.shape[0]
    step = train.build_train_step(state.model, cfg)
    outs = []
    hooks = [s.model.register_forward_hook(lambda mod, args, out: outs.append(out))
             for s in (state, plain_state) if s is not None]
    params_before = [p.detach().clone() for p in state.model.parameters()]
    stats_before = [b.clone() for b in state.model.buffers()]
    reset_counts(mods, records)
    t0 = time.perf_counter()
    state, metrics = step(state, clouds, corr, mask)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(mods, records)
    check_launches(counts, launches, f"{what} train step")
    text = f"launches {counts}"
    if launches:
        with plain_kernels(mods):
            before = read_counts(mods, records)
            plain_state, plain_metrics = train.build_train_step(plain_state.model, cfg)(plain_state, clouds, corr, mask)
            torch.cuda.synchronize()
            if read_counts(mods, records) != before:
                raise AssertionError(f"{what}: the plain train step launched a kernel")
        ref, plain = outs
        check_provenance(torch, ref, plain, cfg["model_type"], f"{what} train step")
        errs = {k: abs(metrics[k].item() - v.item()) / abs(v.item()) for k, v in plain_metrics.items()}
        stats_err = max((a - b).abs().max().item() for a, b in zip(state.model.buffers(), plain_state.model.buffers()))
        if max(errs.values()) > 1e-6 or stats_err > 1e-6:
            raise AssertionError(f"{what} train step: metrics {errs} or BN statistics (max abs err {stats_err}) "
                                 f"differ from the plain-kernel run")
        text = (f"provenance indices equal to the plain path; metrics max rel err {max(errs.values()):.3g}, BN "
                f"statistics max abs err {stats_err:.3g}; " + text)
        del ref, plain
    for h in hooks:
        h.remove()
    centers = getattr(outs[0], "center_idx_origin", None)
    del plain_state, outs                           # the outputs hold activations: out of the timed peak
    for key, value in metrics.items():
        if not (torch.isfinite(value) and value.item() > 0):
            raise AssertionError(f"{what} train step: {key} = {value.item()} is not finite and positive")
    if all(torch.equal(a, b) for a, b in zip(params_before, state.model.parameters())):
        raise AssertionError(f"{what} train step: no parameter changed")
    if any(torch.equal(a, b) for a, b in zip(stats_before, state.model.buffers())):
        raise AssertionError(f"{what} train step: a BatchNorm statistic did not change")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError(f"{what} train step: a parameter is not finite")
    say(f"{what} train: {text}")
    if not timed_steps:
        return counts, None, centers

    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, clouds, corr, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, clouds, corr, mask)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / TRAIN_STEPS
    last = {k: round(v.item(), 6) for k, v in metrics.items()}
    if not all(torch.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what} train step: non-finite metrics {last}")
    patches = (f", patch branch on {int(mask.sum())} clouds, {cfg['A2B_MAX_ROWS']} a2b rows"
               if what == "patch_aug_net" else "")
    measured(f"{what} train step, {total} clouds x {cfg['NUM_POINTS']} points ({cfg['TRAIN_BATCH_SIZE']} x "
             f"{total // cfg['TRAIN_BATCH_SIZE']}){patches}",
             f"{sec * 1e3:.2f} ms per step ({TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up; first step "
             f"{first_ms:.2f} ms), {total / sec:.1f} clouds/s, peak memory "
             f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, step {state.step} metrics {last}")
    return counts, sec * 1e3, centers


class HostClock:
    """Host seconds spent in named functions, by wrapping them in place
    (``patch``); ``undo`` restores every original."""

    def __init__(self):
        self.seconds, self.calls, self._saved = {}, {}, []

    def wrap(self, label, fn, before=None, after=None):
        def timed(*args, **kwargs):
            if before is not None:
                before()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0
                self.calls[label] = self.calls.get(label, 0) + 1
                if after is not None:
                    after()
        return timed

    def patch(self, owner, name, label, **hooks):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, self.wrap(label, getattr(owner, name), **hooks))

    def undo(self):
        while self._saved:
            owner, name, fn = self._saved.pop()
            setattr(owner, name, fn)


def device_busy_ms(torch, fn):
    """(device busy ms, host wall ms) of ``fn()`` under ``torch.profiler``
    tracing the card alone: the kernels' and copies' device time, summed
    (one stream, so the sum counts each busy instant once)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    key = "self_device_time_total" if hasattr(rows[0], "self_device_time_total") else "self_cuda_time_total"
    return sum(getattr(r, key) for r in rows) / 1e3, wall


def dist_bound(sq_q, sq_d, dim):
    """Bound on the f32 rounding error of ``max(|q|^2 + |d|^2 - 2 q.d, 0)``
    over ``dim`` components, in any summation order: gamma_{dim+2} (|q|^2 +
    |d|^2 + 2 |q| |d|) <= 2 gamma_{dim+2} (|q|^2 + |d|^2), where gamma_n =
    n u / (1 - n u) and u = 2^-24."""
    n = dim + 2
    return 2 * n * F32_UNIT / (1 - n * F32_UNIT) * (sq_q + sq_d)


def check_recall(np, test_ds, what):
    """The eval's recall on the card against the CPU retrieval's on the same
    descriptors, query by query. Each side ranks f32 distances within e
    (``dist_bound``) of the exact ones, so a rank's pick lies within 2e of
    the rank's exact (float64) distance: at every rank that decides
    recall@1 and 1% recall (the first ``threshold``), the two sides' picks
    must lie within 2e of it, and must be equal unless another exact
    distance lies within 2e of it (a near-tie may round either way).
    Pairs' recalls can then differ only by near-tied queries. Leaves the
    scene's retrieval on the CPU. Returns (pairs, queries, near-tied
    queries whose picks differ)."""
    on_card = test_ds.get_recall_precision(top_k=25, collect_query_results=True)
    scene = test_ds.scene
    scene.device = "cpu"
    on_cpu = test_ds.get_recall_precision(top_k=25, collect_query_results=True)
    descs = scene.global_descs.astype(np.float64)
    sq = (descs ** 2).sum(-1)
    trips = scene.trip_indices()
    queries = differ = 0
    for (qt, rt), card in on_card.items():
        cpu = on_cpu[qt, rt]
        if qt == rt:
            raise AssertionError(f"{what}: a trip against itself is not compared here (its own leading match)")
        db = np.asarray(trips[rt])
        if card.threshold > 5 or len(card.query_results) != len(cpu.query_results):
            raise AssertionError(f"{what}, trips {(qt, rt)}: {card.threshold} ranks decide, or the sides evaluated "
                                 f"{len(card.query_results)} and {len(cpu.query_results)} queries")
        for a, b in zip(card.query_results, cpu.query_results):
            q = a["query"]
            exact = ((descs[db] - descs[q]) ** 2).sum(-1)
            dist = dict(zip(db.tolist(), exact.tolist()))
            ranked = np.sort(exact)
            tie = 2 * dist_bound(sq[q], sq[db].max(), descs.shape[1])
            for j in range(card.threshold):
                x, y = a["topN"][j], b["topN"][j]
                off = max(abs(dist[x] - ranked[j]), abs(dist[y] - ranked[j]))
                near = np.sum(np.abs(ranked - ranked[j]) <= tie) > 1
                if off > tie or (x != y and not near):
                    raise AssertionError(f"{what}, trips {(qt, rt)}, query {q}, rank {j}: card {x}, CPU {y}, "
                                         f"{off:.3g} from the rank's exact distance (tie {tie:.3g})")
            queries += 1
            differ += a["topN"][:card.threshold] != b["topN"][:card.threshold]
    return len(on_card), queries, differ


def check_mined(np, retrieval, train_ds, mined):
    """Hard negatives mined on the card against the CPU retrieval's on the
    same descriptors, position by position. Each side ranks f32 distances
    that lie within e (``dist_bound``) of the exact ones, so a rank's f32
    order statistic lies within e of the exact one and its pick within 2e.
    Every pick of either list must lie within 2e of its rank's exact
    (float64) distance, and the lists must be equal at every position
    whose exact distance lies more than 2e from both of its neighbours'
    (a near-tie there may round either way). ``mined``: query -> the
    card's list. Returns what the report prints."""
    scene = train_ds.scene
    queries = sorted(mined)
    negatives = [scene.get_tuple(q, -1, scene.data_cfg["skip_trip_itself"]).negative_indices for q in queries]
    want = retrieval.hard_negatives_batch(scene.global_descs[queries], scene.global_descs, negatives,
                                          train_ds.num_hard_neg, device="cpu")
    if not mined or len(want) != len(mined):
        raise AssertionError("hard-negative mining on the card returned no lists")
    descs = scene.global_descs.astype(np.float64)
    sq = (descs ** 2).sum(-1)
    out = {"lists": len(queries), "equal": 0, "positions": 0, "near": 0, "differ": 0, "tol": 0.0,
           "spreads": [], "within": 0, "gap": float("inf")}
    for q, negs, cpu in zip(queries, negatives, want):
        got, k = mined[q], len(cpu)
        out["equal"] += got == cpu
        if len(got) != k or len(set(got)) != k or not set(got) <= set(negs):
            raise AssertionError(f"hard negatives of query {q}: {got} against the CPU's {cpu}")
        if not k:
            continue
        negs = np.asarray(negs)
        exact = ((descs[negs] - descs[q]) ** 2).sum(-1)
        dist = dict(zip(negs.tolist(), exact.tolist()))
        ranked = np.sort(exact)
        gaps = np.diff(ranked)
        tie = 2 * dist_bound(sq[q], sq[negs].max(), descs.shape[1])
        for i, (a, b) in enumerate(zip(got, cpu)):
            off = max(abs(dist[a] - ranked[i]), abs(dist[b] - ranked[i]))
            if off > tie:
                raise AssertionError(f"hard negatives of query {q}, rank {i}: a pick lies {off:.3g} from the "
                                     f"rank's exact distance, past {tie:.3g} (card {got}, CPU {cpu})")
            near = (i > 0 and gaps[i - 1] <= tie) or (i < len(gaps) and gaps[i] <= tie)
            if a != b and not near:
                raise AssertionError(f"hard negatives of query {q}, rank {i}: card {a}, CPU {b}, no exact "
                                     f"distance within {tie:.3g} (card {got}, CPU {cpu})")
            out["near"] += bool(near)
            out["differ"] += a != b
        out["positions"] += k
        out["tol"] = max(out["tol"], tie)
        out["spreads"].append(ranked[-1] - ranked[k - 1])
        out["within"] = max(out["within"], int(np.sum(ranked[k:] - ranked[k - 1] <= tie)))
        if len(ranked) > k:
            out["gap"] = min(out["gap"], gaps[k - 1])
    return out


def phase_cli(torch, mods, records, step_ms):
    """The port's CLIs at full width on the synthetic scene: train an epoch,
    evaluate the checkpoint, refresh the descriptors and mine hard
    negatives on the card; then where a CLI batch's time goes."""
    import tempfile

    import numpy as np

    import evaluate_torch
    import train_torch
    from patchaugnet_tpu_torch import train
    from patchaugnet_tpu_torch.data import retrieval, tuple_dataset
    from patchaugnet_tpu_torch.train import loop

    config = os.path.join(ROOT, CLI_CONFIG)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        # 1. train: one epoch of train_torch.py, its host parts timed and
        # the launches read at the edges of every centres call and step
        clock = HostClock()
        marks = []                                          # (what, host clock, counts) at each edge

        def mark(what):
            return lambda: marks.append((what, time.perf_counter(), read_counts(mods, records)))

        clock.patch(tuple_dataset.PlaceRecognitionDataset, "sample_batch", "sample")
        clock.patch(tuple_dataset.PlaceRecognitionDataset, "_batch_overlaps", "overlaps")
        clock.patch(loop, "prepare_patch_inputs", "prepare", before=mark("prepare"), after=mark("prepared"))
        clock.patch(loop, "build_correspondences", "tables")
        build_step = train.build_train_step

        def timed_build_train_step(*args, **kwargs):
            return clock.wrap("step", build_step(*args, **kwargs), before=mark("step"), after=mark("stepped"))

        train.build_train_step = timed_build_train_step
        argv = ["--config", config, "--dataset", "synthetic", "--epochs", "1", "--exp_dir",
                os.path.join(tmp, "train")]
        try:
            reset_counts(mods, records)
            run = train_torch.main(argv)
            torch.cuda.synchronize()
            train_counts = read_counts(mods, records)
        finally:
            train.build_train_step = build_step
            clock.undo()
        summary = run["summaries"][0]
        batches, patch_batches = summary["batches"], summary["patch_batches"]
        cfg = run["cfg"]
        clouds_per_batch = cfg["TRAIN_BATCH_SIZE"] * (cfg["TRAIN_POSITIVES_PER_QUERY"]
                                                      + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 2)
        if batches == 0 or patch_batches != batches:
            raise AssertionError(f"CLI train: {batches} batches, {patch_batches} with overlap tables")
        windows = {"prepared": ("prepare", CENTER_LAUNCHES), "stepped": ("step", STEP_LAUNCHES)}
        for (w0, _, c0), (w1, _, c1) in zip(marks, marks[1:]):
            if w1 in windows:
                opened, want = windows[w1]
                if w0 != opened:
                    raise AssertionError(f"CLI train: {w1} after {w0}")
                check_launches({k: c1[k] - c0[k] for k in c1}, want, f"CLI train, one batch's {opened}")
        per_batch = {k: CENTER_LAUNCHES.get(k, 0) + STEP_LAUNCHES.get(k, 0) for k in train_counts}
        check_launches(train_counts, {k: v * batches for k, v in per_batch.items()}, "CLI train epoch")
        losses = {k: v for k, v in summary.items() if k in ("total", "place_recognition", "patch_recon_a2a",
                                                             "patch_recon_a2b")}
        if len(losses) != 4 or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"CLI train: epoch losses {losses}")
        with open(os.path.join(cfg["event_dir"], "metrics.jsonl")) as f:
            steps = [json.loads(line) for line in f if '"iter_loss"' in line]
        if len(steps) != batches or not all(np.isfinite(r["train_total"]) for r in steps):
            raise AssertionError(f"CLI train: {len(steps)} logged steps for {batches} batches, or a loss not finite")
        ckpt = os.path.join(cfg["save_path"], "train_epoch_0_end")
        if not os.path.exists(ckpt):
            raise AssertionError(f"CLI train: no checkpoint {ckpt}")
        wall_ms = summary["seconds"] * 1e3
        starts = [t for what, t, _ in marks if what == "step"]
        steady_ms = (starts[-1] - starts[0]) * 1e3 / (len(starts) - 1)
        measured(f"CLI train_torch.py, {cfg['NUM_POINTS']}-point synthetic scene, {len(run['train_ds'])} train "
                 f"records, 1 epoch",
                 f"{batches} batches of {clouds_per_batch} clouds, all with overlap tables; the epoch "
                 f"{wall_ms / batches:.2f} ms per batch, {clouds_per_batch * batches / summary['seconds']:.1f} "
                 f"clouds/s (its last metric reads and checkpoint included); from the first step's call to the "
                 f"last's {steady_ms:.2f} ms per batch, {clouds_per_batch / steady_ms * 1e3:.1f} clouds/s "
                 f"(phase 5's step alone: {step_ms:.2f} ms); launches {train_counts} (K1 3 + 1 and K2 6 per "
                 f"batch); epoch losses {({k: round(v, 6) for k, v in losses.items()})}")
        host = {k: v * 1e3 / batches for k, v in clock.seconds.items()}
        sampling = host["sample"] - host["overlaps"]
        centres = host["prepare"] - host["tables"]
        host_parts = host["sample"] + host["prepare"]
        measured("CLI train batch, host ms per batch",
                 f"tuple sampling {sampling:.2f}, synthetic overlaps {host['overlaps']:.2f}, centres (the "
                 f"copy, the FPS and the read, waiting behind the previous step) {centres:.2f}, table building "
                 f"{host['tables']:.2f}; the step's call {host['step']:.2f} (copy and queue); the rest (metric "
                 f"reads, checkpoint) {wall_ms / batches - host_parts - host['step']:.2f}; host parts "
                 f"{host_parts / (wall_ms / batches):.1%} of a batch")

        # the same run under the profiler, for the card's idle share over
        # the epoch (its busy time includes the set-up's few copies)
        prof_argv = ["--config", config, "--dataset", "synthetic", "--epochs", "1", "--exp_dir",
                     os.path.join(tmp, "profiled")]
        profiled = {}
        busy, _ = device_busy_ms(torch, lambda: profiled.update(run=train_torch.main(prof_argv)))
        prof = profiled.pop("run")["summaries"][0]
        epoch_ms = prof["seconds"] * 1e3
        measured("CLI train epoch again under torch.profiler (the card traced alone)",
                 f"device busy {busy / prof['batches']:.2f} ms per batch in a {epoch_ms / prof['batches']:.2f} ms "
                 f"batch, card {1 - busy / epoch_ms:.1%} idle over the epoch")

        # 2. evaluate the untrained model (the CLI's initialisation, no
        # --weight), then the checkpoint
        untrained = evaluate_torch.main(["--config", config, "--dataset", "synthetic", "--no_save_top_k",
                                         "--exp_dir", os.path.join(tmp, "eval_untrained")])
        reset_counts(mods, records)
        t0 = time.perf_counter()
        result = evaluate_torch.main(["--config", config, "--weight", ckpt, "--dataset", "synthetic",
                                      "--exp_dir", os.path.join(tmp, "eval")])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_counts = read_counts(mods, records)
        test_ds, eval_batch = result["test_ds"], evaluate_torch.get_args([]).batch_size
        descs = test_ds.scene.global_descs
        forwards = -(-len(test_ds) // eval_batch)
        check_launches(eval_counts, {k: v * forwards for k, v in FORWARD_LAUNCHES.items()}, "CLI eval")
        if descs.shape != (len(test_ds), 256) or not np.isfinite(descs).all():
            raise AssertionError(f"CLI eval: descriptors {descs.shape} not finite ({len(test_ds)}, 256)")
        norm_err = float(np.abs(np.linalg.norm(descs, axis=-1) - 1).max())
        if norm_err > 1e-5:
            raise AssertionError(f"CLI eval: descriptors not unit-norm (max |norm - 1| = {norm_err})")
        if result["num_pairs"] != 2 or not os.path.exists(result["top_k_path"]):
            raise AssertionError(f"CLI eval: {result['num_pairs']} trip pairs, top-k dump "
                                 f"{result.get('top_k_path')}")
        pairs, queries, ties = check_recall(np, test_ds, "CLI eval")
        measured(f"CLI evaluate_torch.py on the checkpoint, {len(test_ds)} test records",
                 f"recall@1 {result['recall_at_1']:.2f}, recall@1% {result['ave_one_percent_recall']:.2f} over "
                 f"{result['num_pairs']} trip pairs (the picks deciding them equal to the CPU retrieval's on the "
                 f"same descriptors for {queries - ties} of {queries} queries, near-tied within the f32 bound for "
                 f"{ties}); the untrained model (no --weight): recall@1 "
                 f"{untrained['recall_at_1']:.2f}, recall@1% {untrained['ave_one_percent_recall']:.2f}; the whole "
                 f"eval {eval_s:.2f} s; launches {eval_counts}; descriptors max |norm - 1| {norm_err:.2g}")

        # the eval's descriptor sweep again, timed: one padded batch of the
        # CLI's size per sweep of the test split
        sweeps = []
        for _ in range(EVAL_REPEATS + 1):
            t0 = time.perf_counter()
            test_ds.update_global_descs(result["forward"], batch_size=eval_batch)
            sweeps.append((time.perf_counter() - t0) * 1e3)
        sweep_ms = np.array(sweeps[1:])
        measured(f"CLI eval forward, {EVAL_REPEATS} sweeps of the {len(test_ds)} test records after a warm-up, "
                 f"{forwards} padded batch of {eval_batch} each (clouds read, forward, descriptors fetched)",
                 f"median {np.median(sweep_ms):.4f} ms per sweep (min {sweep_ms.min():.4f}, max "
                 f"{sweep_ms.max():.4f}): {np.median(sweep_ms) / (forwards * eval_batch):.4f} ms per batch slot, "
                 f"{np.median(sweep_ms) / len(test_ds):.4f} ms per record; the CLI's own timer, one cold batch: "
                 f"{result['desc_time']['mean_ms']:.4f} ms per slot")

        # 3. refresh the train descriptors and mine hard negatives on the card
        train_ds, model = run["train_ds"], run["state"].model
        refresh_batch = 36
        modes = []
        hook = model.register_forward_pre_hook(lambda module, args: modes.append(module.training))
        if not model.training:
            raise AssertionError("CLI: the model is not in train mode after training")
        reset_counts(mods, records)
        try:
            train_ds.update_global_descs(run["forward"], batch_size=refresh_batch)
        finally:
            hook.remove()
        torch.cuda.synchronize()
        refresh_counts = read_counts(mods, records)
        check_launches(refresh_counts,
                       {k: v * -(-len(train_ds) // refresh_batch) for k, v in FORWARD_LAUNCHES.items()},
                       "descriptor refresh")
        if not modes or any(modes) or not model.training:
            raise AssertionError(f"C-2: the refresh ran in train mode ({modes}) or left the model in eval mode")
        t0 = time.perf_counter()
        train_ds.mine_hard_negatives(np.random.RandomState(0))
        mine_ms = (time.perf_counter() - t0) * 1e3
        lists = dict(train_ds.scene.hard_negative_indices)
        mined = check_mined(np, retrieval, train_ds, lists)
        # a control: each list's last pick swapped for its query's farthest
        # negative must fail the check
        descs = train_ds.scene.global_descs.astype(np.float64)
        wrong = {}
        for q, got in lists.items():
            negs = [n for n in train_ds.scene.get_tuple(q, -1, train_ds.scene.data_cfg["skip_trip_itself"])
                    .negative_indices if n not in got]
            far = max(negs, key=lambda n: ((descs[n] - descs[q]) ** 2).sum()) if got and negs else None
            wrong[q] = got[:-1] + [far] if far is not None else got
        try:
            check_mined(np, retrieval, train_ds, wrong)
        except AssertionError:
            pass
        else:
            raise AssertionError("the mining check passed lists that end in their farthest negative")
        # the same mining on seeded random unit descriptors, whose distances
        # lie further apart than the rounding bound: the check then holds
        # most ranks exactly
        scene, trained = train_ds.scene, train_ds.scene.global_descs
        noise = np.random.RandomState(3).randn(*trained.shape).astype(np.float32)
        scene.global_descs = noise / np.linalg.norm(noise, axis=1, keepdims=True)
        train_ds.mine_hard_negatives(np.random.RandomState(0))
        spread = check_mined(np, retrieval, train_ds, dict(scene.hard_negative_indices))
        scene.global_descs = trained
        scene.hard_negative_indices.update(lists)
        for what, m in (("the trained model's", mined), ("random unit", spread)):
            spreads = np.array(m["spreads"])
            say(f"CLI mining on {what} descriptors, {m['lists']} queries: {m['equal']} lists equal to "
                f"the CPU retrieval's; of {m['positions']} ranks, {m['near']} at an exact near-tie (within "
                f"{m['tol']:.3g}, twice the f32 rounding bound of a distance over 256 components) and "
                f"{m['differ']} of those differing, every other rank equal, every pick within {m['tol']:.3g} of "
                f"its rank's exact distance; exact distance from the k-th to the last candidate: min "
                f"{spreads.min():.4g}, median {np.median(spreads):.4g}; at most {m['within']} candidates past "
                f"the k-th within the tolerance of it; smallest gap between the k-th and the next: {m['gap']:.3g}")
        say(f"CLI refresh and mining: the refresh ran the model in eval mode ({len(modes)} forwards) and left it "
            f"in train mode; mining on the card {mine_ms:.2f} ms; lists ending in their farthest negative fail "
            f"the check; launches {refresh_counts}")

        # the eval batch and a refresh batch through the plain versions: K1
        # and K2 at these batch sizes take layouts that phases 2-5 do not
        # hold (``ops.knn.lanes_for`` picks the lanes by the batch)
        dev = next(model.parameters()).device
        for what, ds, size in (("eval batch", test_ds, eval_batch), ("refresh batch", train_ds, refresh_batch)):
            check_level_shapes(torch, mods, dev, size, f"the CLI's {what}")
            idx = list(range(min(size, len(ds))))
            clouds, _ = ds.scene.get_clouds(idx)
            clouds = np.concatenate([clouds, np.repeat(clouds[-1:], size - len(idx), 0)])
            _, err = check_against_plain(torch, mods, records, model, torch.as_tensor(clouds, device=dev),
                                         "patch_aug_net", f"CLI {what} of {size}")
            say(f"CLI {what} of {size} clouds: provenance indices equal to the plain path, descriptor max abs "
                f"err {err:.3g}")
        if not model.training:
            raise AssertionError("CLI: the plain-path check left the model in eval mode")
    return train_counts, eval_counts, refresh_counts


def time_ppt_kernels(torch, ops, mods, dev):
    """K1 and K2 at the level shapes of a PPT-Net forward at B=32 that a
    PatchAugNet forward does not launch (K1 at SA1-SA3, K2 at SA1-SA3 and
    FP1-FP3; SA0 and FP0 are PatchAugNet's), each equal to its plain
    version and timed beside it and the ``torch.topk`` yardstick, each on a
    line of its own. The kernels' records, and so the ``kernels`` line's
    sums, keep the PatchAugNet forward's shapes alone."""
    fps, knn = mods["fps"], mods["knn"]
    x = level_clouds(torch, ops, fps._farthest_point_sample_torch, torch.Generator(device=dev).manual_seed(8), B,
                     PPT_LEVELS)
    for level in range(1, len(PPT_LEVELS)):
        pts, m = x[level], x[level + 1].shape[1]
        n = pts.shape[1]
        if not torch.equal(ops.farthest_point_sample(pts, m), fps._farthest_point_sample_torch(pts, m)):
            raise AssertionError(f"fps PPT-Net SA{level}: kernel indices differ from the plain version")
        ms = time_ms(torch, lambda: ops.farthest_point_sample(pts, m), 20)
        plain = time_ms(torch, lambda: fps._farthest_point_sample_torch(pts, m), 2)
        b_ms, b_by = fps_bound(B, n, m)
        measured(f"K1 fps PPT-Net SA{level} (b,n,m)=({B},{n},{m}), layout {fps.layout_for(n)}",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), indices equal")
    for label, pts, qry, k in knn_cases(x):
        if label in ("SA0", "FP0"):
            continue
        n, m = pts.shape[1], qry.shape[1]
        check_equal(torch, f"knn PPT-Net {label}", ops.knn(pts, qry, k), knn._knn_torch(pts, qry, k))
        ms = time_ms(torch, lambda: ops.knn(pts, qry, k), 20)
        plain = time_ms(torch, lambda: knn._knn_torch(pts, qry, k), 3)
        lib, pair_ms = knn_yardsticks(torch, ops, pts, qry, k)
        b_ms, b_by = knn_bound(B, n, m, k)
        measured(f"K2 knn PPT-Net {label} (b,n,m,k)=({B},{n},{m},{k}), "
                 f"{knn.lanes_for(B, n, m, k, mods['cuda'].sm_count(dev))} lanes per query",
                 f"kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.topk on the distance matrix {lib:.4f} ms "
                 f"(+{pair_ms:.4f} ms to form it), bound {b_ms:.4f} ms ({b_by}), indices and d2 equal")


def cli_family(torch, mods, records, family, config, launches, forward_launches):
    """``train_torch.py`` for FAMILY_CLI_BATCHES batches of ``config`` on the
    synthetic scene, on the card (``launches`` per batch, no overlap tables:
    the patch branch is PatchAugNet's), then ``evaluate_torch.py`` on its
    checkpoint: recall checked against the CPU retrieval's on the same
    descriptors (``check_recall``), ``forward_launches`` per eval forward; the eval's forward
    choice takes the global forward for a model without local
    descriptors. Returns the train and eval launch counts."""
    import tempfile

    import numpy as np

    import evaluate_torch
    import train_torch

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{family}_") as tmp:
        reset_counts(mods, records)
        t0 = time.perf_counter()
        run = train_torch.main(["--config", config, "--dataset", "synthetic", "--epochs", "1", "--max-batches",
                                str(FAMILY_CLI_BATCHES), "--exp_dir", os.path.join(tmp, "train")])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = read_counts(mods, records)
        summary, cfg = run["summaries"][0], run["cfg"]
        smoothap = cfg.get("LOSS_FUNCTION", "").lower() == "truncatedsmoothap"
        if smoothap:                    # flat batches: the step counts them, the loss is SmoothAP's
            batches, loss, tables = run["state"].step, summary["loss"], 0
            clouds = cfg.get("SMOOTHAP_BATCH_SIZE", 16)
        else:
            batches, loss, tables = summary["batches"], summary["total"], summary["patch_batches"]
            clouds = cfg["TRAIN_BATCH_SIZE"] * (cfg["TRAIN_POSITIVES_PER_QUERY"] + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 2)
        if batches != FAMILY_CLI_BATCHES or tables or not np.isfinite(loss):
            raise AssertionError(f"CLI {family}: {batches} batches, {tables} with overlap tables, loss {loss}")
        check_launches(train_counts, {k: v * batches for k, v in launches.items()}, f"CLI {family} train")
        ckpt = os.path.join(cfg["save_path"], "train_epoch_0_end")
        reset_counts(mods, records)
        result = evaluate_torch.main(["--model_type", family, "--config", config, "--weight", ckpt, "--dataset",
                                      "synthetic", "--no_save_top_k", "--exp_dir", os.path.join(tmp, "eval")])
        torch.cuda.synchronize()
        eval_counts = read_counts(mods, records)
        test_ds = result["test_ds"]
        forwards = -(-len(test_ds) // evaluate_torch.get_args([]).batch_size)
        check_launches(eval_counts, {k: v * forwards for k, v in forward_launches.items()}, f"CLI {family} eval")
        descs = test_ds.scene.global_descs
        if descs.shape != (len(test_ds), 256) or not np.isfinite(descs).all():
            raise AssertionError(f"CLI {family} eval: descriptors {descs.shape} not finite ({len(test_ds)}, 256)")
        pairs, queries, ties = check_recall(np, test_ds, f"CLI {family} eval")
        model = run["state"].model
        dev = next(model.parameters()).device
        chosen = evaluate_torch.eval_forward(model, dev, local=True)(test_ds.scene.get_clouds([0, 1])[0])
        if isinstance(chosen, tuple) != (family not in ("pointnet_vlad", "minkloc3dv2")):
            raise AssertionError(f"CLI {family} eval: the forward choice took the wrong forward")
        measured(f"CLI {family}: train_torch.py {batches} {'SmoothAP ' if smoothap else ''}batches of {clouds}"
                 f" clouds on the {cfg['NUM_POINTS']}-point synthetic scene, then evaluate_torch.py on its checkpoint",
                 f"train {train_s:.2f} s in all (the scene's set-up{' and an eval' if smoothap else ''} included), "
                 f"epoch loss {loss:.6f}, "
                 f"launches {train_counts}; eval recall@1 {result['recall_at_1']:.2f}, recall@1% "
                 f"{result['ave_one_percent_recall']:.2f} over {result['num_pairs']} trip pairs (the deciding picks "
                 f"equal to the CPU retrieval's for {queries - ties} of {queries} queries, near-tied for {ties}), "
                 f"launches {eval_counts}; the eval's forward choice "
                 f"{'local' if isinstance(chosen, tuple) else 'global'}")
    return train_counts, eval_counts


def phase_families(torch, ops, mods, records, dev):
    """PPT-Net and PointNetVLAD at full width through the port's entry
    points: K1 and K2 at PPT-Net's level shapes, serving, the train step
    and the CLIs. Returns every run's launch counts."""
    from patchaugnet_tpu_torch import configs
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import l2_normalize, seeded_init_

    time_ppt_kernels(torch, ops, mods, dev)
    for batch in FAMILY_BATCHES:
        check_level_shapes(torch, mods, dev, batch, "PPT-Net's levels", PPT_LEVELS, tied=True)
    paths = []

    cfg = configs.PPTNET_ORIGIN
    ppt = seeded_init_(get_model("pptnet", cfg), torch.Generator().manual_seed(10))
    counts, clouds, descs = serve(torch, mods, records, dev, ppt, "pptnet", PPT_LAUNCHES, seed=11)
    desc = descs[0]
    paths.append(counts)
    normed = get_model("pptnet_l2_norm", cfg).to(dev)
    normed.load_state_dict(ppt.state_dict())
    normed.eval()
    reset_counts(mods, records)
    with torch.inference_mode():
        unit = normed(clouds).global_desc
    counts = read_counts(mods, records)
    check_launches(counts, PPT_LAUNCHES, "pptnet_l2_norm forward")
    paths.append(counts)
    norm_err = (unit.norm(dim=-1) - 1).abs().max().item()
    same_err = (unit - l2_normalize(desc, dim=-1)).abs().max().item()
    if norm_err > 1e-5 or same_err > 1e-6:
        raise AssertionError(f"pptnet_l2_norm: max |norm - 1| {norm_err}, {same_err} from pptnet's normalised")
    say(f"pptnet_l2_norm: unit-norm descriptors (max |norm - 1| {norm_err:.2g}), {same_err:.2g} from pptnet's "
        f"normalised on the same weights; pptnet's norms {desc.norm(dim=-1).min().item():.4g} to "
        f"{desc.norm(dim=-1).max().item():.4g}")
    del ppt, normed
    paths.append(train_model(torch, mods, records, dev, cfg,
                             seeded_init_(get_model("pptnet", cfg), torch.Generator().manual_seed(13)),
                             "pptnet", PPT_STEP_LAUNCHES, seed=12)[0])

    cfg = configs.POINTNET_VLAD
    pnv = seeded_init_(get_model("pointnet_vlad", cfg), torch.Generator().manual_seed(14))
    paths.append(serve(torch, mods, records, dev, pnv, "pointnet_vlad", PNV_LAUNCHES, seed=11)[0])
    del pnv
    paths.append(train_model(torch, mods, records, dev, cfg,
                             seeded_init_(get_model("pointnet_vlad", cfg), torch.Generator().manual_seed(15)),
                             "pointnet_vlad", {}, seed=12)[0])

    for family, config, launches, forward_launches in (
            ("pptnet", "configs/pptnet_origin.yaml", PPT_STEP_LAUNCHES, PPT_LAUNCHES),
            ("pointnet_vlad", "configs/pointnet_vlad.yaml", {}, PNV_LAUNCHES)):
        paths.extend(cli_family(torch, mods, records, family, os.path.join(ROOT, config), launches,
                                forward_launches))
    return paths


def pyramid_tensors(pyramid):
    """(name, tensor) of every table, map and count of a MinkLoc pyramid."""
    out = [(f"level {i} keys", t.keys) for i, t in enumerate(pyramid.tables)]
    out += [(f"level {i} mask", t.mask) for i, t in enumerate(pyramid.tables)]
    out += [("conv0 routes", pyramid.conv0_routes), ("overflow", pyramid.overflow)]
    out += [(f"block routes {i}", r) for i, r in enumerate(pyramid.block_routes)]
    out += [(f"down routes {i}", r) for i, r in enumerate(pyramid.down_routes)]
    for i, (idx, valid) in enumerate(pyramid.up_nbr):
        out += [(f"up map {i}", idx), (f"up valid {i}", valid)]
    return out


def check_minkloc_cpu(torch, model, clouds, descs):
    """The served model on ``clouds`` against a deep copy on the CPU:
    coords, ``valid`` and every pyramid tensor equal, descriptors (served
    on the card: ``descs``) within MINK_DESC_TOL."""
    cpu = copy.deepcopy(model).cpu().eval()
    model.eval()
    with torch.inference_mode():
        pairs = list(zip(zip(("coords", "valid"), model.quantize(clouds)[:2]),
                         zip(("coords", "valid"), cpu.quantize(clouds.cpu())[:2])))
        card_pyr, cpu_pyr = model.pyramid(clouds), cpu.pyramid(clouds.cpu())
        if card_pyr.dims != cpu_pyr.dims:
            raise AssertionError(f"minkloc3dv2: level dims {card_pyr.dims} on the card, {cpu_pyr.dims} on the CPU")
        pairs += list(zip(pyramid_tensors(card_pyr), pyramid_tensors(cpu_pyr)))
        for (name, a), (_, b) in pairs:
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                raise AssertionError(f"minkloc3dv2 {name}: the card's differs from the CPU's")
        err = (descs.cpu() - cpu(clouds.cpu())).abs().max().item()
    if err > MINK_DESC_TOL:
        raise AssertionError(f"minkloc3dv2: descriptors on the card differ from the CPU's by {err}")
    say(f"minkloc3dv2 against the CPU on {clouds.shape[0]} clouds: coords, valid and {len(pairs) - 2} pyramid tensors "
        f"(5 levels' keys and masks, conv0, 4 block and 4 down maps, 2 up maps, overflow) equal; descriptors max "
        f"abs err {err:.3g}")


def check_minkloc_dense(torch, model, clouds, dev):
    """The dense backend at its capped grid (48^3, ``grid_size_for_step``
    under ``max_grid_size`` 48) with ``model``'s weights: its FPN on the
    occupancy grid of ``clouds`` against the sparse FPN on the voxel tables
    of the same occupied cells, equal at the stored sites of the output
    level within MINK_FPN_TOL; its descriptors finite."""
    from patchaugnet_tpu_torch import configs
    from patchaugnet_tpu_torch.models import get_model, minkloc3dv2 as mk, minkloc_sparse as ms

    dense = get_model("minkloc3dv2", dict(configs.MINKLOC3DV2, backend="dense")).to(dev).eval()
    dense.load_state_dict(model.state_dict())
    model.eval()
    levels = dense.backbone.num_bottom_up
    with torch.inference_mode():
        grid, occ = dense.voxelize(clouds)
        g = occ.shape[1]
        coords = torch.zeros(clouds.shape[0], clouds.shape[1], 3, dtype=torch.int32, device=dev)
        valid = torch.zeros(clouds.shape[:2], dtype=torch.bool, device=dev)
        for b in range(clouds.shape[0]):
            cells = torch.nonzero(occ[b]).to(torch.int32)
            coords[b, :len(cells)], valid[b, :len(cells)] = cells, True
        pyr = ms.build_pyramid(coords, valid, (g, g, g), levels, dense.backbone.num_top_down,
                               dense.conv0_kernel_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yd, dmask = dense.backbone(grid, mk.dense_masks(occ, levels))
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3
        ys, _ = model.backbone(None, [t.mask for t in pyr.tables], pyr)
        out = levels - dense.backbone.num_top_down
        table, dims = pyr.tables[out], pyr.dims[out]
        err, sites = 0.0, 0
        for b in range(clouds.shape[0]):
            cells = ms.decompose_keys(table.keys[b, table.mask[b]], dims).long()
            if int(dmask[b].sum()) != len(cells) or not dmask[b][tuple(cells.T)].all():
                raise AssertionError("minkloc3dv2 dense: the FPN output's occupancy differs from the sparse tables'")
            err = max(err, (yd[b][tuple(cells.T)] - ys[b, table.mask[b]]).abs().max().item())
            sites += len(cells)
        desc = dense(clouds)
    if err > MINK_FPN_TOL or not torch.isfinite(desc).all():
        raise AssertionError(f"minkloc3dv2 dense: FPN max abs err {err} against the sparse FPN, or non-finite "
                             f"descriptors")
    measured(f"minkloc3dv2 dense backend at {g}^3 on {clouds.shape[0]} clouds",
             f"FPN output at {sites} stored sites of level {out} within {err:.3g} of the sparse FPN's on the same "
             f"occupancy (shared weights); dense FPN {dense_ms:.2f} ms; descriptors finite")


def smoothap_batch(torch, dev, seed, clouds=MINK_STEP_CLOUDS):
    """A pair-expanded batch: ``clouds // 2`` random clouds in [-1, 1]^3,
    each followed by a copy moved by gaussian noise of 0.005 (its positive);
    each pair positive, every other cloud a negative."""
    gen = torch.Generator().manual_seed(seed)
    anchors = torch.rand(clouds // 2, N_POINTS, 3, generator=gen) * 2 - 1
    moved = anchors + 0.005 * torch.randn(anchors.shape, generator=gen)
    pair = torch.arange(clouds) // 2
    pos = (pair[:, None] == pair[None]) & ~torch.eye(clouds, dtype=torch.bool)
    return torch.stack([anchors, moved], dim=1).reshape(clouds, N_POINTS, 3).to(dev), pos, pair[:, None] != pair[None]


def minkloc_train(torch, mods, records, dev, cfg):
    """The SmoothAP step (``train.build_smoothap_train_step``: AdamW at the
    config's decay under MultiStepLR) at full width on ``smoothap_batch``:
    no kernel launch; one step from a deep copy on the CPU, loss and ap
    within MINK_STEP_RTOL and new BatchNorm statistics within
    MINK_STATS_TOL; parameters and statistics changed and finite; then ms
    per step, clouds/s and peak memory over TRAIN_STEPS steps after
    TRAIN_WARMUP. Returns the launch counts."""
    from patchaugnet_tpu_torch import train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    model = seeded_init_(get_model("minkloc3dv2", cfg), torch.Generator().manual_seed(22))
    schedule = train.multistep_schedule(cfg["BASE_LEARNING_RATE"], cfg.get("scheduler_milestones", [250, 350]), 1000)
    step, tx = train.build_smoothap_train_step(model, schedule, weight_decay=cfg["WEIGHT_DECAY"], tau1=cfg["tau1"],
                                               positives_per_query=cfg["positives_per_query"])
    state = train.create_train_state(model, cfg, device=dev, tx=tx)
    cpu_state = copy.deepcopy(state)
    cpu_state.model.cpu()
    clouds, pos, neg = smoothap_batch(torch, dev, seed=23)
    params_before = [p.detach().clone() for p in state.model.parameters()]
    stats_before = [b.clone() for b in state.model.buffers()]
    reset_counts(mods, records)
    t0 = time.perf_counter()
    state, metrics = step(state, clouds, pos, neg)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(mods, records)
    check_launches(counts, {}, "minkloc3dv2 SmoothAP step")
    t0 = time.perf_counter()
    cpu_state, cpu_metrics = step(cpu_state, clouds.cpu(), pos, neg)
    cpu_s = time.perf_counter() - t0
    errs = {k: abs(metrics[k].item() - cpu_metrics[k].item()) / max(abs(cpu_metrics[k].item()), 1e-12)
            for k in ("loss", "ap")}
    stats_err = max((a.cpu() - b).abs().max().item() for a, b in zip(state.model.buffers(), cpu_state.model.buffers()))
    param_err = max((a.detach().cpu() - b.detach()).abs().max().item()
                    for a, b in zip(state.model.parameters(), cpu_state.model.parameters()))
    if max(errs.values()) > MINK_STEP_RTOL or stats_err > MINK_STATS_TOL:
        raise AssertionError(f"minkloc3dv2 SmoothAP step: loss/ap rel err {errs} or BN statistics max abs err "
                             f"{stats_err} against the CPU")
    if not 0 < metrics["loss"].item() < 1 or not all(torch.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"minkloc3dv2 SmoothAP step: metrics {metrics}")
    if all(torch.equal(a, b) for a, b in zip(params_before, state.model.parameters())):
        raise AssertionError("minkloc3dv2 SmoothAP step: no parameter changed")
    if any(torch.equal(a, b) for a, b in zip(stats_before, state.model.buffers())):
        raise AssertionError("minkloc3dv2 SmoothAP step: a BatchNorm statistic did not change")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("minkloc3dv2 SmoothAP step: a parameter is not finite")
    del cpu_state, params_before, stats_before
    say(f"minkloc3dv2 SmoothAP step against the CPU (a deep copy, {cpu_s:.2f} s there): loss/ap max rel err "
        f"{max(errs.values()):.3g}, BN statistics max abs err {stats_err:.3g}, parameters after the update max abs "
        f"diff {param_err:.3g} (AdamW's first update moves each by about lr = {schedule(0)}); launches {counts}")
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, clouds, pos, neg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, clouds, pos, neg)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / TRAIN_STEPS
    last = {k: round(v.item(), 6) for k, v in metrics.items()}
    if not all(torch.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"minkloc3dv2 SmoothAP step: non-finite metrics {last}")
    measured(f"minkloc3dv2 SmoothAP step, {clouds.shape[0]} clouds x {N_POINTS} points (pair-expanded)",
             f"{sec * 1e3:.2f} ms per step ({TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up; first step "
             f"{first_ms:.2f} ms), {clouds.shape[0] / sec:.1f} clouds/s, peak memory "
             f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, step {state.step} metrics {last}")
    return counts


def phase_minkloc(torch, mods, records, dev):
    """MinkLoc3Dv2 at full width through the port's entry points: serving,
    the CPU comparison, the level occupancy, the dense backend, the
    SmoothAP step and the CLIs, each launching none of the port's kernels.
    Returns every run's launch counts."""
    from patchaugnet_tpu_torch import configs
    from patchaugnet_tpu_torch.models import get_model, minkloc_sparse as ms
    from patchaugnet_tpu_torch.nn import seeded_init_

    t_phase = time.perf_counter()
    cfg = configs.MINKLOC3DV2
    model = seeded_init_(get_model("minkloc3dv2", cfg), torch.Generator().manual_seed(20))
    if model.backend != "sparse" or model.level_capacity is not None or model.quantization_step != 0.01:
        raise AssertionError("minkloc3dv2: the config must build the sparse backend at step 0.01, full capacity")
    counts, clouds, descs = serve(torch, mods, records, dev, model, "minkloc3dv2", {}, seed=21)
    paths = [counts]
    check_minkloc_cpu(torch, model, clouds[:MINK_CPU_CLOUDS], descs[0][:MINK_CPU_CLOUDS])
    occ = ms.measure_level_occupancy(clouds, num_levels=len(cfg["layers"]), quantization_step=cfg["quantization_step"])
    measured(f"minkloc3dv2 level occupancy of the {clouds.shape[0]} served clouds (uniform in [0, 1]^3, "
             f"{N_POINTS} points, table capacity {N_POINTS} at every level)",
             "; ".join(f"level {i} mean {occ[:, i].mean():.1f} (min {occ[:, i].min()}, max {occ[:, i].max()})"
                       for i in range(occ.shape[1])))
    check_minkloc_dense(torch, model, clouds[:MINK_DENSE_CLOUDS], dev)
    del model, descs
    paths.append(minkloc_train(torch, mods, records, dev, cfg))
    paths.extend(cli_family(torch, mods, records, "minkloc3dv2", os.path.join(ROOT, "configs/minkloc3dv2.yaml"), {},
                            {}))
    say(f"phase 8 (minkloc3dv2): {time.perf_counter() - t_phase:.1f} s")
    return paths


# the fresh serving process of phase 9: loads the PatchAugNet artifacts
# (argv: the checkout, the directory they lie in, their batch size; the
# bf16 one in its bf16/ subdirectory), serves the requests saved there,
# and prints one JSON line: per request the launch counts of each
# artifact's call, the load and first-call seconds, the TF32 and bf16
# reduction flags, and whether the port's models were imported; the
# outputs go to served.pt
SERVE_SCRIPT = r"""
import importlib, json, os, sys, time
root, out, batch = sys.argv[1:4]
sys.path.insert(0, root)
import torch
t0 = time.perf_counter()
from patchaugnet_tpu_torch import serving
fps, knn, topk, norm = (importlib.import_module(f"patchaugnet_tpu_torch.ops.{name}")
                        for name in ("fps", "knn", "topk", "norm"))
fwd, meta = serving.load_artifact(os.path.join(out, f"patch_aug_net_desc_b{batch}.pt2"))
t1 = time.perf_counter()
lfwd, lmeta = serving.load_artifact(os.path.join(out, f"patch_aug_net_local_b{batch}.pt2"))
t2 = time.perf_counter()
bfwd, bmeta = serving.load_artifact(os.path.join(out, "bf16", f"patch_aug_net_desc_b{batch}.pt2"))
requests = torch.load(os.path.join(out, "requests.pt")).cuda()
counters = ((fps, "launches"), (knn, "launches"), (topk, "launches"), (topk, "price_launches"),
            (topk, "chunked_launches"), (norm, "launches"))
def counts():
    return {f"{m.__name__.rsplit('.', 1)[1]}.{c}": getattr(m, c) for m, c in counters}
def reset():
    for m, c in counters:
        setattr(m, c, 0)
served, calls, first = [], [], None
for x in requests:
    reset()
    t = time.perf_counter()
    g = fwd(x)
    torch.cuda.synchronize()
    first = first if first is not None else time.perf_counter() - t
    one = counts()
    reset()
    lg, loc, ci = lfwd(x)
    torch.cuda.synchronize()
    two = counts()
    reset()
    b16 = bfwd(x)
    torch.cuda.synchronize()
    calls.append({"desc": one, "local": two, "bf16": counts()})
    served.append({"desc": g.cpu(), "global": lg.cpu(), "local": loc.cpu(), "center_idx": ci.cpu(), "bf16": b16.cpu()})
torch.save(served, os.path.join(out, "served.pt"))
print(json.dumps({"calls": calls, "load_s": [t1 - t0, t2 - t1], "first_call_s": first,
                  "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                  "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                  "bf16_reduction": torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
                  "models_imported": any(m.startswith("patchaugnet_tpu_torch.models") for m in sys.modules),
                  "meta": [meta, lmeta, bmeta]}))
"""


def served_alike(torch, want, got, what):
    """``got`` equal to ``want`` (float outputs within 1e-6, integer ones
    exactly); returns the largest float difference."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}, expected {want.dtype} {tuple(want.shape)}")
    if not want.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: indices differ from the live forward's")
        return 0.0
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all() or err > DEPLOY_TOL:
        raise AssertionError(f"{what}: {err} from the live forward's")
    return err


def in_turns(torch, fns, arg, iters):
    """Seconds per call of each of ``fns`` (name -> callable) on ``arg``, in
    turns (a, b, b, a), each over ``iters`` calls after a warm-up call."""
    out = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        fns[name](arg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fns[name](arg)
        torch.cuda.synchronize()
        out[name].append((time.perf_counter() - t0) / iters)
    return out


def time_forwards(torch, forwards, clouds, iters):
    """Seconds per batch of each of ``forwards`` (name -> callable) on
    ``clouds``, in turns (``in_turns``), and the host's seconds to queue one
    call (the median of ``ENQUEUE_REPS``, each behind a sleep kernel that
    holds the stream, so the call only queues), twice per forward; returns
    name -> [two timings], name -> [two queueing times]."""
    out = in_turns(torch, forwards, clouds, iters)
    queue = {name: [] for name in forwards}
    for name in list(forwards) * 2:
        reps = []
        for _ in range(ENQUEUE_REPS):
            torch.cuda._sleep(4 * SLEEP_CYCLES)
            t0 = time.perf_counter()
            forwards[name](clouds)
            reps.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        queue[name].append(sorted(reps)[len(reps) // 2])
    return out, queue


def export_cli(out, *args):
    """``export_serving_torch.py``'s ``main`` into ``out``; returns (paths, seconds)."""
    import export_serving_torch

    t0 = time.perf_counter()
    written = export_serving_torch.main([*args, "--out", out])
    return written, time.perf_counter() - t0


def deploy_families(torch, mods, records, dev, out, clouds):
    """PPT-Net's (4 K1, 8 K2 and 25 fused BatchNorm + ReLU per call),
    PointNetVLAD's (4 fused BatchNorm + ReLU) and MinkLoc3Dv2's (no launch)
    global artifacts at B=32 from their seeded initialisation,
    each held against the live forward on ``clouds``. Returns the launch
    counts of the artifacts' calls."""
    import evaluate_torch
    from patchaugnet_tpu_torch import configs, serving

    paths = []
    for family, launches in (("pptnet", PPT_LAUNCHES), ("pointnet_vlad", PNV_LAUNCHES), ("minkloc3dv2", {})):
        (path,), export_s = export_cli(out, "--model_type", family, "--batch_sizes", str(B))
        cfg = dict(configs.KNOWN_CONFIGS[os.path.basename(evaluate_torch.CONFIG_TABLE[family])], model_type=family)
        model = evaluate_torch.load_state(family, cfg, None, dev).model
        art, meta = serving.load_artifact(path)
        reset_counts(mods, records)
        got = art(clouds)
        counts = read_counts(mods, records)
        check_launches(counts, launches, f"{family} artifact")
        paths.append(counts)
        err = served_alike(torch, serving.build_forward_fn(model, dev)(clouds), got, f"{family} artifact")
        measured(f"{family} artifact, B={B}, seeded initialisation",
                 f"export {export_s:.2f} s, {meta['bytes'] / 1e6:.1f} MB, launches {counts}, max abs difference to "
                 f"the live forward {err:.3g}")
    return paths


def phase_deploy(torch, mods, records, dev):
    """The deployment path: a full-width reference-layout checkpoint of
    ``configs.PATCH_AUG_NET`` exported by ``export_serving_torch.py`` at
    B=32 and B=100, global and local; the B=32 artifacts served in a fresh
    process (started as soon as they exist, while this one exports the
    rest and checks the other families) against the live model fed the
    same checkpoint; then descriptors/s of both. Returns every counted
    run's launches."""
    import tempfile

    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.compat import load_torch_checkpoint, save_reference_checkpoint
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as out:
        cfg = configs.PATCH_AUG_NET
        pth = os.path.join(out, "patch_aug_net_ref.pth")
        save_reference_checkpoint(pth, "patch_aug_net",
                                  seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(30)), cfg)
        gen = torch.Generator(device=dev).manual_seed(31)
        requests = torch.rand(REQUESTS, B, N_POINTS, 3, generator=gen, device=dev)
        torch.save(requests.cpu(), os.path.join(out, "requests.pt"))
        reset_counts(mods, records)
        written, export_s = [], 0.0
        fresh = None
        try:
            for batch in DEPLOY_BATCHES:
                paths, secs = export_cli(out, "--model_type", "patch_aug_net", "--weight", pth, "--batch_sizes",
                                         str(batch), "--with_local")
                written, export_s = written + paths, export_s + secs
                if fresh is None:
                    (bf16_path,), bf16_s = export_cli(os.path.join(out, "bf16"), "--model_type", "patch_aug_net",
                                                      "--weight", pth, "--batch_sizes", str(batch), "--precision",
                                                      "bfloat16")
                    fresh = subprocess.Popen([sys.executable, "-c", SERVE_SCRIPT, ROOT, out, str(batch)],
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            check_launches(read_counts(mods, records), {}, "export (traced, no launch)")
            deployed = deploy_families(torch, mods, records, dev, out, requests[0])
            stdout, stderr = fresh.communicate(timeout=600)
        finally:
            if fresh is not None and fresh.poll() is None:
                fresh.kill()
                fresh.wait()
        if fresh.returncode != 0:
            raise AssertionError(f"the fresh serving process failed:\n{stderr[-4000:]}")
        report = json.loads(stdout.strip().splitlines()[-1])
        if report["models_imported"] or report["matmul_tf32"] or report["cudnn_tf32"] or report["bf16_reduction"]:
            raise AssertionError(f"fresh serving process: models imported {report['models_imported']}, TF32 "
                                 f"matmul {report['matmul_tf32']}, cuDNN {report['cudnn_tf32']}, bf16 reductions "
                                 f"{report['bf16_reduction']}")
        if report["meta"][2]["precision"] != "bfloat16":
            raise AssertionError(f"the bf16 artifact's sidecar says precision {report['meta'][2]['precision']}")
        per_call = {flavour: {f"{rec.module}.{rec.counter}": n for rec in records if (n := launches.get(rec.name))}
                    for flavour, launches in (("desc", FORWARD_LAUNCHES), ("local", FORWARD_LAUNCHES),
                                              ("bf16", bf16_launches(FORWARD_LAUNCHES)))}
        for i, call in enumerate(report["calls"]):
            for flavour, counts in call.items():
                want = per_call[flavour]
                if {k: v for k, v in counts.items() if v} != want:
                    raise AssertionError(f"artifact {flavour} request {i}: launches {counts}, expected {want}")
        deployed.append({rec.name: sum(counts.get(f"{rec.module}.{rec.counter}", 0)
                                       for call in report["calls"] for counts in call.values()) for rec in records})

        live = load_torch_checkpoint(pth, "patch_aug_net", cfg, get_model("patch_aug_net", cfg))
        forward, local = serving.build_forward_fn(live, dev), serving.build_local_forward_fn(live, dev)
        bf16_cfg = dict(cfg, COMPUTE_DTYPE="bfloat16")
        bf16_forward = serving.build_forward_fn(
            load_torch_checkpoint(pth, "patch_aug_net", bf16_cfg, get_model("patch_aug_net", bf16_cfg)), dev)
        errs, bf16_cos = [], 1.0
        for i, (x, got) in enumerate(zip(requests, torch.load(os.path.join(out, "served.pt")))):
            g = forward(x).cpu()
            lg, loc, ci = (t.cpu() for t in local(x))
            errs += [served_alike(torch, g, got["desc"], f"artifact desc request {i}"),
                     served_alike(torch, lg, got["global"], f"artifact local request {i}: global"),
                     served_alike(torch, loc, got["local"], f"artifact local request {i}: local"),
                     served_alike(torch, ci, got["center_idx"], f"artifact local request {i}: centre indices")]
            b16 = bf16_forward(x).cpu()
            if got["bf16"].dtype != torch.float32 or not torch.equal(got["bf16"], b16):
                raise AssertionError(f"bf16 artifact request {i}: not bit-equal to the live bf16 forward (max abs "
                                     f"difference {(got['bf16'].float() - b16).abs().max().item()})")
            bf16_cos = min(bf16_cos, torch.nn.functional.cosine_similarity(b16, g, dim=-1).min().item())
        if bf16_cos < MIN_COSINE:
            raise AssertionError(f"bf16 artifact: min cosine {bf16_cos} to the f32 artifact's descriptors")
        measured(f"patch_aug_net bf16 artifact B={B} from the same .pth (export_serving_torch.py --precision "
                 f"bfloat16), served by the fresh process",
                 f"export {bf16_s:.2f} s; {REQUESTS} requests: K1 3 and K2 6 per call, bit-equal to the live bf16 "
                 f"forward, min cosine {bf16_cos:.6f} to the f32 descriptors; bf16 reductions off in the fresh process")
        metas = {os.path.basename(p): json.load(open(p + ".json")) for p in written}
        measured(f"patch_aug_net artifacts from a reference .pth ({', '.join(metas)})",
                 f"export {export_s:.2f} s in all for {len(written)} (each "
                 + ", ".join(f"{m['export_seconds']:.2f}" for m in metas.values()) + " s), sizes "
                 + ", ".join(f"{m['bytes'] / 1e6:.1f}" for m in metas.values()) + " MB; in a fresh process load "
                 + " / ".join(f"{t:.2f}" for t in report["load_s"]) + f" s (desc / local B={B}), first call "
                 f"{report['first_call_s'] * 1e3:.1f} ms; {REQUESTS} requests of {B} x {N_POINTS}: K1 3 and K2 6 per "
                 f"call of each artifact, nothing else; TF32 off; models not imported; max abs difference to the "
                 f"live forward on the same .pth {max(errs):.3g} (centre indices equal)")

        for batch, iters in THROUGHPUT_BATCHES:
            art, _ = serving.load_artifact(os.path.join(out, f"patch_aug_net_desc_b{batch}.pt2"))
            clouds = torch.rand(batch, N_POINTS, 3, generator=gen, device=dev)
            reset_counts(mods, records)
            served_alike(torch, forward(clouds), art(clouds), f"artifact B={batch}")
            deployed.append(read_counts(mods, records))
            secs, queue = time_forwards(torch, {"live": forward, "artifact": art}, clouds, iters)
            measured(f"patch_aug_net throughput B={batch}, live forward against the artifact, in turns",
                     "; ".join(f"{name} " + " / ".join(f"{batch / s:.1f}" for s in v) + " descriptors/s ("
                               + " / ".join(f"{s * 1e3:.2f}" for s in v) + " ms per batch, the host queues a call in "
                               + " / ".join(f"{q * 1e3:.2f}" for q in queue[name]) + " ms)"
                               for name, v in secs.items()) + f", {iters} batches each")
    say(f"phase 9 (deployment): {time.perf_counter() - t_phase:.1f} s")
    return deployed


def bf16_twin(torch, model_type, cfg, model, dev):
    """``model_type`` built at ``cfg`` with ``COMPUTE_DTYPE: bfloat16`` on
    ``model``'s weights (the same f32 tree), on ``dev``, in ``model``'s mode."""
    from patchaugnet_tpu_torch.models import get_model

    twin = get_model(model_type, dict(cfg, COMPUTE_DTYPE="bfloat16")).to(dev)
    twin.load_state_dict(model.state_dict())
    return twin.train(model.training)


def peak_gib(torch, dev, fn, arg):
    """Peak device memory (GiB) of one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fn(arg)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) / 2**30


def all_f32(torch, state):
    """Whether every parameter, buffer and optimizer tensor of ``state`` is f32."""
    tensors = [*state.model.parameters(), *state.model.buffers()]
    tensors += [v for s in state.optimizer.state.values() for v in s.values() if torch.is_tensor(v) and v.dim()]
    return all(t.dtype == torch.float32 for t in tensors)


def precision_serving(torch, mods, records, dev):
    """Each family at full width (seeded f32 weights) and its bf16 twin on
    the same weights, at B=32 and B=100: the bf16 descriptors f32, finite,
    within MIN_COSINE of the f32 forward's; the same kernel launches;
    PatchAugNet's and PPT-Net's provenance indices equal and FP features
    f32, MinkLoc3Dv2's tables and maps equal; descriptors/s of both in
    turns and each forward's peak memory. Returns the launch counts."""
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    paths = []
    gen = torch.Generator(device=dev).manual_seed(40)
    for i, (family, cfg_name, launches) in enumerate(PRECISION_FAMILIES):
        cfg = getattr(configs, cfg_name)
        f32 = seeded_init_(get_model(family, cfg), torch.Generator().manual_seed(41 + i)).to(dev).eval()
        bf16 = bf16_twin(torch, family, cfg, f32, dev)
        forwards = {"f32": serving.build_forward_fn(f32, dev), "bf16": serving.build_forward_fn(bf16, dev)}
        for batch, iters in PRECISION_BATCHES:
            x = torch.rand(batch, N_POINTS, 3, generator=gen, device=dev)
            outs, counts = {}, {}
            for name, model in (("f32", f32), ("bf16", bf16)):
                reset_counts(mods, records)
                with torch.inference_mode():
                    outs[name] = model(x)
                torch.cuda.synchronize()
                counts[name] = read_counts(mods, records)
                want = launches if name == "f32" else bf16_launches(launches)
                check_launches(counts[name], want, f"{family} {name} forward B={batch}")
                paths.append(counts[name])
            d32, d16 = (serving.global_desc(outs[k]) for k in ("f32", "bf16"))
            if d16.dtype != torch.float32 or d16.shape != d32.shape or not torch.isfinite(d16).all():
                raise AssertionError(f"{family} bf16 B={batch}: descriptors {d16.dtype} {tuple(d16.shape)}, "
                                     f"expected finite float32 {tuple(d32.shape)}")
            cos = torch.nn.functional.cosine_similarity(d16, d32, dim=-1).min().item()
            if cos < MIN_COSINE:
                raise AssertionError(f"{family} bf16 B={batch}: min cosine to the f32 forward {cos} < {MIN_COSINE}")
            text = f"min cosine to the f32 forward {cos:.6f}"
            if family in PROVENANCE:
                check_provenance(torch, outs["bf16"], outs["f32"], family, f"{family} bf16 B={batch}")
                if any(f.dtype != torch.float32 for f in outs["bf16"].fp_features):
                    raise AssertionError(f"{family} bf16 B={batch}: fp_features are not float32")
                text += ", provenance indices equal to the f32 forward's, fp_features f32"
            if family == "minkloc3dv2":
                with torch.inference_mode():
                    for (name, a), (_, b) in zip(pyramid_tensors(bf16.pyramid(x)), pyramid_tensors(f32.pyramid(x)),
                                                 strict=True):
                        if not torch.equal(a, b):
                            raise AssertionError(f"minkloc3dv2 bf16 B={batch}: {name} differs from the f32 path's")
                text += ", every table and kernel map equal to the f32 path's"
            del outs, d32, d16
            secs = in_turns(torch, forwards, x, iters)
            peaks = {name: peak_gib(torch, dev, fn, x) for name, fn in forwards.items()}
            measured(f"{family} bf16 against f32 serving, B={batch} x {N_POINTS} points, in turns",
                     f"{text}; launches per forward {counts['bf16']} (f32 {counts['f32']}); "
                     + "; ".join(f"{name} " + " / ".join(f"{batch / s:.1f}" for s in v) + " descriptors/s ("
                                 + " / ".join(f"{s * 1e3:.2f}" for s in v) + f" ms per batch, {iters} batches), peak "
                                 f"memory {peaks[name]:.3f} GiB" for name, v in secs.items()))
        del f32, bf16, forwards
    return paths


def precision_train(torch, mods, records, dev):
    """The flagship train step at 72 clouds, bf16 against f32 from the same
    seeded weights: PRECISION_STEPS bf16 steps, each launching K1 3 and K2
    6 times, metrics finite, every parameter, statistic and Adam moment
    f32; ms per step of both in turns and peak memory. MinkLoc3Dv2's bf16
    SmoothAP step at 16 clouds once. Returns the launch counts."""
    from patchaugnet_tpu_torch import configs, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    cfg = configs.PATCH_AUG_NET_TRAIN
    cfgs = {"f32": cfg, "bf16": dict(cfg, COMPUTE_DTYPE="bfloat16")}
    model = seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(45))
    models = {"f32": model, "bf16": bf16_twin(torch, "patch_aug_net", cfg, model, dev)}
    states = {k: train.create_train_state(m, cfgs[k], device=dev) for k, m in models.items()}
    steps = {k: train.build_train_step(s.model, cfgs[k]) for k, s in states.items()}
    clouds, mask, corr = train_batch(torch, cfg, dev, seed=46)
    paths, totals = [], []
    for _ in range(PRECISION_STEPS):
        reset_counts(mods, records)
        states["bf16"], metrics = steps["bf16"](states["bf16"], clouds, corr, mask)
        torch.cuda.synchronize()
        paths.append(read_counts(mods, records))
        check_launches(paths[-1], STEP_LAUNCHES, "patch_aug_net bf16 train step")
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"patch_aug_net bf16 train step: metrics {metrics}")
        totals.append(metrics["total"].item())
    if not all_f32(torch, states["bf16"]):
        raise AssertionError("patch_aug_net bf16 train step: a parameter, statistic or Adam moment is not float32")

    def stepper(name):
        def run(_):
            states[name], _m = steps[name](states[name], clouds, corr, mask)
        return run

    runs = {name: stepper(name) for name in states}
    secs = in_turns(torch, runs, None, PRECISION_STEPS)
    peaks = {name: peak_gib(torch, dev, fn, None) for name, fn in runs.items()}
    measured(f"patch_aug_net train step bf16 against f32, {clouds.shape[0]} clouds x {cfg['NUM_POINTS']} points, "
             f"in turns",
             f"bf16 totals over {PRECISION_STEPS} checked steps {[round(t, 6) for t in totals]}, K1 3 and K2 6 "
             f"launches per step, parameters, statistics and Adam moments f32; "
             + "; ".join(f"{name} " + " / ".join(f"{s * 1e3:.2f}" for s in v) + f" ms per step, peak memory "
                         f"{peaks[name]:.3f} GiB" for name, v in secs.items()))
    del states, steps, models, model

    mcfg = configs.MINKLOC3DV2
    mk = seeded_init_(get_model("minkloc3dv2", dict(mcfg, COMPUTE_DTYPE="bfloat16")), torch.Generator().manual_seed(47))
    schedule = train.multistep_schedule(mcfg["BASE_LEARNING_RATE"], mcfg.get("scheduler_milestones", [250, 350]),
                                        1000)
    step, tx = train.build_smoothap_train_step(mk, schedule, weight_decay=mcfg["WEIGHT_DECAY"], tau1=mcfg["tau1"],
                                               positives_per_query=mcfg["positives_per_query"])
    state = train.create_train_state(mk, mcfg, device=dev, tx=tx)
    clouds, pos, neg = smoothap_batch(torch, dev, seed=48)
    before = [p.detach().clone() for p in state.model.parameters()]
    reset_counts(mods, records)
    t0 = time.perf_counter()
    state, metrics = step(state, clouds, pos, neg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    paths.append(read_counts(mods, records))
    check_launches(paths[-1], {}, "minkloc3dv2 bf16 SmoothAP step")
    if not 0 < metrics["loss"].item() < 1 or not all(torch.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"minkloc3dv2 bf16 SmoothAP step: metrics {metrics}")
    if not all_f32(torch, state) or all(torch.equal(a, b) for a, b in zip(before, state.model.parameters())):
        raise AssertionError("minkloc3dv2 bf16 SmoothAP step: a tensor of the state is not float32, or nothing moved")
    say(f"minkloc3dv2 bf16 SmoothAP step, {clouds.shape[0]} clouds: {ms:.2f} ms (the first step: cuDNN and cuBLAS "
        f"pick their kernels), metrics {({k: round(v.item(), 6) for k, v in metrics.items()})}, every tensor of "
        f"the state f32, no kernel launch")
    return paths


def precision_remat(torch, mods, records, dev):
    """The flagship step with ``REMAT`` at 72 clouds against the plain step,
    each from a deep copy of one state, both under
    ``torch.use_deterministic_algorithms`` (the gathers' backward adds with
    atomics, in another order on each run: two plain steps alone differ by
    up to 2 lr in the parameters whose gradient is rounding noise, which
    Adam's first update moves by lr times its sign): the total within
    REMAT_RTOL, every parameter within REMAT_ATOL, the running statistics
    equal (updated once: each moved), K1 and K2 launching twice as often
    (the recomputed forward). Then, in the default mode, ms per step of
    both in turns and each step's peak memory. Returns the launch counts."""
    from patchaugnet_tpu_torch import configs, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    cfg = configs.PATCH_AUG_NET_TRAIN
    cfgs = {"plain": cfg, "remat": dict(cfg, REMAT=True)}
    state = train.create_train_state(seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(49)),
                                     cfg, device=dev)
    stats0 = [b.clone() for b in state.model.buffers()]
    clouds, mask, corr = train_batch(torch, cfg, dev, seed=50)
    runs, paths = {}, []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, launches in (("plain", STEP_LAUNCHES), ("remat", {k: 2 * v for k, v in STEP_LAUNCHES.items()})):
            s = copy.deepcopy(state)
            reset_counts(mods, records)
            s, metrics = train.build_train_step(s.model, cfgs[name])(s, clouds, corr, mask)
            torch.cuda.synchronize()
            paths.append(read_counts(mods, records))
            check_launches(paths[-1], launches, f"patch_aug_net {name} train step")
            runs[name] = (metrics["total"].item(), [p.detach() for p in s.model.parameters()], list(s.model.buffers()))
            del s
    finally:
        torch.use_deterministic_algorithms(False)
    (t_plain, p_plain, b_plain), (t_remat, p_remat, b_remat) = runs.values()
    rel = abs(t_remat - t_plain) / abs(t_plain)
    param_err = max((a - b).abs().max().item() for a, b in zip(p_remat, p_plain))
    if rel > REMAT_RTOL or param_err > REMAT_ATOL:
        raise AssertionError(f"REMAT step: total rel err {rel}, parameters max abs err {param_err} against the plain "
                             f"step")
    if not all(torch.equal(a, b) for a, b in zip(b_remat, b_plain)) or any(
            torch.equal(a, b) for a, b in zip(b_remat, stats0)):
        raise AssertionError("REMAT step: the running statistics differ from the plain step's, or did not move")
    del runs, p_plain, p_remat, b_plain, b_remat

    states = {name: copy.deepcopy(state) for name in cfgs}
    steps = {name: train.build_train_step(states[name].model, c) for name, c in cfgs.items()}

    def stepper(name):
        def run(_):
            states[name], _m = steps[name](states[name], clouds, corr, mask)
        return run

    fns = {name: stepper(name) for name in cfgs}
    secs = in_turns(torch, fns, None, PRECISION_STEPS)
    peaks = {name: peak_gib(torch, dev, fn, None) for name, fn in fns.items()}
    measured(f"patch_aug_net train step with REMAT against the plain step, {clouds.shape[0]} clouds",
             f"one step each from a copy of one state, deterministic algorithms: total rel err {rel:.3g}, parameters "
             f"max abs err {param_err:.3g}, running statistics equal (updated once); launches {paths[1]} (plain "
             f"{paths[0]}); then in turns: "
             + "; ".join(f"{name} " + " / ".join(f"{x * 1e3:.2f}" for x in v) + f" ms per step, peak memory "
                         f"{peaks[name]:.3f} GiB" for name, v in secs.items()))
    return paths


def phase_precision(torch, mods, records, dev):
    """Mixed precision (``COMPUTE_DTYPE: bfloat16``) and ``REMAT`` at full
    width: serving of the four families, the bf16 train steps, the REMAT
    step. (The bf16 artifact is served by phase 9's fresh process.)
    Returns every run's launch counts."""
    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("cuBLAS may reduce bf16 products in bf16: serving.full_f32_products did not run")
    paths = precision_serving(torch, mods, records, dev)
    paths += precision_train(torch, mods, records, dev)
    paths += precision_remat(torch, mods, records, dev)
    say(f"phase 10 (precision): {time.perf_counter() - t_phase:.1f} s")
    return paths


def rank_modules():
    """The kernel wrappers' modules and their launch records, in a rank."""
    mods = {name: importlib.import_module(f"patchaugnet_tpu_torch.ops.{name}") for name in ("fps", "knn")}
    return mods, [KernelRecord(name, name, "", "") for name in mods]


def timed(torch, fn, reps):
    """(the last result, host ms per call) of ``reps`` calls of ``fn``
    after one warm-up, the card synchronised around them."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def counted(torch, mods, records, fn):
    """``fn()``, the kernel launches it made and its host ms (the card
    synchronised around it)."""
    torch.cuda.synchronize()
    reset_counts(mods, records)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(mods, records), (time.perf_counter() - t0) * 1e3


def ranks_agree(torch, model, mesh):
    """Whether every rank of ``mesh`` holds the same parameters and
    statistics (an elementwise maximum and minimum over the ranks)."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1).double() for t in model.state_dict().values()])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, dist.ReduceOp.MAX, group=mesh.group())
    dist.all_reduce(lo, dist.ReduceOp.MIN, group=mesh.group())
    return bool(torch.equal(hi, lo))


def step_against_single(torch, mods, records, train, state, cfg, run_parallel, clouds, corr, mask):
    """One step through ``run_parallel(state)`` and, from a deep copy made
    before it, one ``train.build_train_step`` step on the whole batch here:
    (total rel err, parameters max abs err, statistics max abs err, the
    parallel metrics, the parallel step's kernel launches). The launches
    are counted around the parallel step alone."""
    single = copy.deepcopy(state)
    (state, metrics), launches, _ = counted(torch, mods, records, lambda: run_parallel(state))
    single, want = train.build_train_step(single.model, cfg)(single, clouds, corr, mask)
    torch.cuda.synchronize()
    rel = abs(metrics["total"].item() - want["total"].item()) / abs(want["total"].item())
    params = max((a - b).abs().max().item() for a, b in zip(state.model.parameters(), single.model.parameters()))
    stats = max((a - b).abs().max().item() for a, b in zip(state.model.buffers(), single.model.buffers()))
    return rel, params, stats, {k: v.item() for k, v in metrics.items()}, launches


def leaf_errors(torch, got, want):
    """(worst leaf, its error, the leaf errors above 1e-5) of the
    gradients of ``got`` against ``want`` (modules), each leaf in relative
    L2, its norm floored at 1e-4 of the largest."""
    want = {k: p.grad.double() for k, p in want.named_parameters()}
    got = {k: p.grad.double() for k, p in got.named_parameters()}
    floor = 1e-4 * max(g.norm().item() for g in want.values())
    errors = {k: (got[k] - g).norm().item() / max(g.norm().item(), floor) for k, g in want.items()}
    worst = max(errors, key=errors.get)
    return worst, errors[worst], {k: round(v, 8) for k, v in errors.items() if v > 1e-5}


@contextlib.contextmanager
def nondeterministic_ops(found):
    """Records in ``found`` the operations that warn, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, that they
    ran without a deterministic implementation."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield
    for w in caught:
        text = str(w.message)
        if "deterministic" in text:
            found.add(text.split(" does not have a deterministic")[0][:120])


def parallel_rank():
    """One rank of phase 11 (b), two ranks sharing the card over gloo:
    every parallel path at full width, each held (on rank 0, after the
    collectives) against its single-process counterpart on the same card.
    Returns rank 0's checks and times, every rank's launch counts per path."""
    import torch

    sys.path.insert(0, ROOT)
    from patchaugnet_tpu_torch import configs, ops, parallel, serving, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    mesh = parallel.make_mesh()
    dev, lead = mesh.device, mesh.rank == 0
    mods, records = rank_modules()
    out = {"counts": {}, "checks": {}, "ms": {}}

    def shard(t):
        n = t.shape[1] // mesh.size
        return t[:, mesh.rank * n:(mesh.rank + 1) * n]

    # the data-parallel flagship step, 36 clouds a rank, its patch rows from both
    cfg = dict(configs.PATCH_AUG_NET_TRAIN, A2A_MAX_CLOUDS=PARALLEL_A2A, OPTIMIZER="momentum")
    clouds, mask, corr = train_batch(torch, cfg, dev, seed=61)
    rows = parallel.host_batch_slice(clouds.shape[0], mesh.rank, mesh.size)
    state = train.create_train_state(seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(62)),
                                     cfg, device=dev)
    step = parallel.build_parallel_train_step(state.model, cfg, mesh)
    local = parallel.make_global_batch(mesh, clouds[rows])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        single = copy.deepcopy(state) if lead else None
        (state, metrics), out["counts"]["dp step"], _ = counted(torch, mods, records,
                                                                lambda: step(state, local, corr, mask[rows]))
        if lead:
            single, want = train.build_train_step(single.model, cfg)(single, clouds, corr, mask)
            out["checks"]["dp step"] = {
                "total": metrics["total"].item(), "single total": want["total"].item(),
                "rel": abs(metrics["total"].item() - want["total"].item()) / abs(want["total"].item()),
                "params": max((a - b).abs().max().item()
                              for a, b in zip(state.model.parameters(), single.model.parameters())),
                "stats": max((a - b).abs().max().item() for a, b in zip(state.model.buffers(), single.model.buffers())),
                "terms": {k: v.item() for k, v in metrics.items()}}
            del single
    finally:
        torch.use_deterministic_algorithms(False)
    out["checks"]["dp ranks agree"] = ranks_agree(torch, state.model, mesh)
    (_, _), out["ms"]["dp step"] = timed(torch, lambda: step(state, local, corr, mask[rows]), PARALLEL_REPS)

    # sharded eval at B=100: each rank its 50 records, the outputs gathered
    eval_model = seeded_init_(get_model("patch_aug_net", configs.PATCH_AUG_NET), torch.Generator().manual_seed(63))
    gen = torch.Generator(device=dev).manual_seed(64)
    records100 = torch.rand((PARALLEL_EVAL_BATCH, N_POINTS, 3), generator=gen, device=dev)
    pfwd = parallel.build_parallel_local_forward(eval_model, mesh)
    (desc, local_feats, centers), out["counts"]["sharded eval"], _ = counted(
        torch, mods, records, lambda: pfwd(parallel.shard_batch(mesh, records100)))
    _, out["ms"]["sharded eval"] = timed(torch, lambda: pfwd(parallel.shard_batch(mesh, records100)), PARALLEL_REPS)

    # point-axis sharded kNN and FPS at 4096 points over the two ranks
    gen = torch.Generator(device=dev).manual_seed(65)
    pts = torch.rand((B, N_POINTS, 3), generator=gen, device=dev)
    qry = pts[:, ::4].contiguous()
    (sk_idx, sk_d2), out["counts"]["sharded_knn"], _ = counted(
        torch, mods, records, lambda: parallel.sharded_knn(shard(pts), qry, 20, mesh))
    _, out["ms"]["sharded_knn"] = timed(torch, lambda: parallel.sharded_knn(shard(pts), qry, 20, mesh), PARALLEL_REPS)
    # one call each of the slow paths below: m collectives per sharded FPS
    sf_idx, out["counts"]["sharded_fps"], out["ms"]["sharded_fps"] = counted(
        torch, mods, records, lambda: parallel.sharded_fps(shard(pts), PATCH_LEVELS[0], mesh))

    # the point-sharded PatchAugNet and PPT-Net descriptors at B=32
    ppt = seeded_init_(get_model("pptnet", configs.PPTNET_ORIGIN), torch.Generator().manual_seed(66)).to(dev)
    eval_model.to(dev)
    descs = {}
    for name, model, fn in (("patchaugnet", eval_model, parallel.sharded_patchaugnet_descriptor),
                            ("pptnet", ppt, parallel.sharded_pptnet_descriptor)):
        descs[name], out["counts"][f"sharded {name}"], out["ms"][f"sharded {name}"] = counted(
            torch, mods, records, lambda: fn(model, shard(pts), mesh, axis_name="data"))

    # one point-sharded PPT-Net train step (18 clouds of 4096 points, 2048 a rank)
    pcfg = dict(configs.PPTNET_ORIGIN, OPTIMIZER="momentum")
    pclouds, pmask, pcorr = train_batch(torch, pcfg, dev, seed=67)
    pstate = train.create_train_state(seeded_init_(get_model("pptnet", pcfg), torch.Generator().manual_seed(68)),
                                      pcfg, device=dev)
    sstep = parallel.build_sharded_train_step(pcfg, mesh, axis_name="data")
    torch.use_deterministic_algorithms(True, warn_only=True)
    sharded_ops, single_ops = set(), set()
    try:
        single = copy.deepcopy(pstate) if lead else None
        before = [p.detach().clone() for p in pstate.model.parameters()]
        with nondeterministic_ops(sharded_ops):
            (pstate, pmetrics), out["counts"]["sharded pptnet step"], out["ms"]["sharded pptnet step"] = counted(
                torch, mods, records, lambda: sstep(pstate, shard(pclouds)))
        if lead:
            with nondeterministic_ops(single_ops):
                single, want = train.build_train_step(single.model, pcfg)(single, pclouds, pcorr, pmask)
            worst, worst_err, leaves = leaf_errors(torch, pstate.model, single.model)
            out["checks"]["pptnet step"] = {
                "total": pmetrics["total"].item(), "single total": want["total"].item(),
                "rel": abs(pmetrics["total"].item() - want["total"].item()) / abs(want["total"].item()),
                "worst leaf": worst, "leaf err": worst_err, "leaves above 1e-5": leaves,
                "params": max((a - b).abs().max().item()
                              for a, b in zip(pstate.model.parameters(), single.model.parameters())),
                "update": max((a - b).abs().max().item() for a, b in zip(single.model.parameters(), before)),
                "stats": max((a - b).abs().max().item()
                             for a, b in zip(pstate.model.buffers(), single.model.buffers())),
                "nondeterministic ops": {"sharded": sorted(sharded_ops), "single": sorted(single_ops)}}
            del single
    finally:
        torch.use_deterministic_algorithms(False)
    out["checks"]["pptnet ranks agree"] = ranks_agree(torch, pstate.model, mesh)
    torch.distributed.barrier()
    if not lead:
        return out

    # rank 0 alone: the single-process counterparts on the same card
    c = out["checks"]
    forward = serving.build_local_forward_fn(eval_model, dev)
    (want_desc, want_local, want_centers), out["ms"]["eval single"] = timed(torch, lambda: forward(records100),
                                                                           PARALLEL_REPS)
    c["sharded eval"] = {"desc": (desc - want_desc).abs().max().item(),
                         "local": (local_feats - want_local).abs().max().item(),
                         "centers equal": bool(torch.equal(centers, want_centers)),
                         "finite unit": bool(torch.isfinite(desc).all()
                                             and ((desc.norm(dim=-1) - 1).abs() < 1e-4).all())}
    (k_idx, k_d2), out["ms"]["knn single"] = timed(torch, lambda: ops.knn(pts, qry, 20), PARALLEL_REPS)
    c["sharded_knn equal"] = bool(torch.equal(sk_idx, k_idx) and torch.equal(sk_d2, k_d2))
    f_idx, out["ms"]["fps single"] = timed(torch, lambda: ops.farthest_point_sample(pts, PATCH_LEVELS[0]),
                                           PARALLEL_REPS)
    c["sharded_fps equal"] = bool(torch.equal(sf_idx, f_idx))
    for name, model in (("patchaugnet", eval_model), ("pptnet", ppt)):
        fwd = serving.build_forward_fn(model, dev)
        want, out["ms"][f"{name} single"] = timed(torch, lambda: fwd(pts), PARALLEL_REPS)
        got = descs[name][0]
        c[f"sharded {name}"] = {"desc": (got - want).abs().max().item(), "finite": bool(torch.isfinite(got).all())}
    return out


def top1_flips(np, retrieval, scene, a, b, dev):
    """The eval's queries (its trip pairs, as ``recall_precision_all``
    pairs them) whose nearest database record differs between the
    descriptors ``a`` and ``b``: (query, a's record, b's record, the gap of
    their squared distances to the query under ``a``, in f64)."""
    skip, trips = scene.data_cfg["skip_trip_itself"], scene.data_cfg["test_query_trips"]
    rows = scene.trip_indices()
    flips = []
    for rt, db in enumerate(rows):
        for qt, qs in enumerate(rows):
            if (skip and qt == rt) or (trips is not None and scene.trip_names[qt] not in trips):
                continue
            first = 1 if qt == rt else 0                 # the query itself leads its own trip's list
            picks = [retrieval.topk_neighbors(d[qs], d[db], first + 1, device=dev)[1][:, first] for d in (a, b)]
            for i in np.nonzero(picks[0] != picks[1])[0]:
                q, x, y = a[qs[i]].astype(np.float64), a[db[picks[0][i]]], a[db[picks[1][i]]]
                flips.append((qs[i], db[picks[0][i]], db[picks[1][i]],
                              float(((q - y) ** 2).sum() - ((q - x) ** 2).sum())))
    return flips


def tie_bound(err, dim):
    """How far apart two unit descriptors' squared distances to a query can
    lie and still swap between two runs whose descriptors differ by at most
    ``err`` per component: each distance moves by at most
    8 err sqrt(D) + 4 err^2 D, and each run's f32 search rounds a distance
    by at most (D + 2) 2^-24 4."""
    return 2 * (8 * err * dim ** 0.5 + 4 * err * err * dim) + 2 * 2 * (dim + 2) * F32_UNIT * 4


def phase_parallel(torch, mods, records, dev):
    """Phase 11: the parallel layer. (a) a world of one under NCCL in this
    process: the flagship data-parallel step at 72 clouds against
    ``build_train_step`` from the same state; (b) two ranks sharing the
    card over gloo (``parallel_rank``); (c) both CLIs at ``--devices 2
    --share-device``. Returns every run's launch counts (both ranks')."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from patchaugnet_tpu_torch import configs, parallel, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    import evaluate_torch
    import train_torch

    t_phase = time.perf_counter()
    paths = []

    # (a) a world of one under NCCL, the flagship config (Adam), deterministic
    # algorithms on both sides
    cfg = dict(configs.PATCH_AUG_NET_TRAIN, A2A_MAX_CLOUDS=PARALLEL_A2A)
    store = tempfile.mkdtemp(prefix="pan_world_")
    parallel.init_process(0, 1, os.path.join(store, "store"), platform="gpu")
    try:
        mesh = parallel.make_mesh()
        clouds, mask, corr = train_batch(torch, cfg, dev, seed=60)
        state = train.create_train_state(seeded_init_(get_model("patch_aug_net", cfg), torch.Generator().manual_seed(59)),
                                         cfg, device=dev)
        step = parallel.build_parallel_train_step(state.model, cfg, mesh)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            rel, params, stats, terms, counts = step_against_single(
                torch, mods, records, train, state, cfg, lambda s: step(s, clouds, corr, mask), clouds, corr, mask)
        finally:
            torch.use_deterministic_algorithms(False)
        check_launches(counts, STEP_LAUNCHES, "world of one: the data-parallel step")
        paths.append(counts)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if rel > PARALLEL_RTOL or params > PARALLEL_ATOL or stats > PARALLEL_ATOL or not np.isfinite(terms["total"]):
        raise AssertionError(f"world of one: total rel err {rel}, parameters {params}, statistics {stats} against "
                             f"build_train_step")
    measured(f"phase 11 (a): data-parallel step, world of one ({backend}), {clouds.shape[0]} clouds, patch rows "
             f"{PARALLEL_A2A}", f"total {terms['total']:.6f} (rel err {rel:.3g} against build_train_step from the same "
             f"state), max parameter difference {params:.3g}, statistics {stats:.3g}; launches {paths[-1]}")

    # (b) two ranks sharing the card over gloo
    t0 = time.perf_counter()
    ranks = parallel.spawn(parallel_rank, PARALLEL_RANKS, platform="gpu", share_device=True)
    world_s = time.perf_counter() - t0
    want = {"dp step": STEP_LAUNCHES, "sharded eval": FORWARD_LAUNCHES, "sharded_knn": {"knn": 1}, "sharded_fps": {},
            "sharded patchaugnet": {"fps": 2, "knn": 6}, "sharded pptnet": {"fps": 3, "knn": 8},
            "sharded pptnet step": {"fps": 3, "knn": 8}}
    for r, rank in enumerate(ranks):
        for path, counts in rank["counts"].items():
            check_launches({k: counts.get(k, 0) for k in ("fps", "knn")}, want[path], f"rank {r} {path}")
            paths.append(counts)
    c, ms = ranks[0]["checks"], ranks[0]["ms"]
    dp, pp = c["dp step"], c["pptnet step"]
    failures = []
    if dp["rel"] > PARALLEL_RTOL or dp["params"] > PARALLEL_ATOL or dp["stats"] > PARALLEL_ATOL:
        failures.append(f"data-parallel step {dp}")
    if not all(v > 0 and np.isfinite(v) for v in dp["terms"].values()):
        failures.append(f"data-parallel step terms {dp['terms']}")
    if pp["rel"] > PARALLEL_RTOL or pp["leaf err"] > PARALLEL_GRAD_RTOL or pp["stats"] > PARALLEL_ATOL:
        failures.append(f"PPT-Net sharded step {pp}")
    if not (c["dp ranks agree"] and c["pptnet ranks agree"] and ranks[1]["checks"]["dp ranks agree"]):
        failures.append("the ranks' parameters differ")
    ev = c["sharded eval"]
    if ev["desc"] > PARALLEL_DESC_TOL or ev["local"] > PARALLEL_DESC_TOL or not (ev["centers equal"]
                                                                                and ev["finite unit"]):
        failures.append(f"sharded eval {ev}")
    if not (c["sharded_knn equal"] and c["sharded_fps equal"]):
        failures.append(f"sharded_knn equal {c['sharded_knn equal']}, sharded_fps equal {c['sharded_fps equal']}")
    for name in ("patchaugnet", "pptnet"):
        if c[f"sharded {name}"]["desc"] > PARALLEL_DESC_TOL or not c[f"sharded {name}"]["finite"]:
            failures.append(f"sharded {name} {c[f'sharded {name}']}")
    if failures:
        raise AssertionError("phase 11 (b): " + "; ".join(failures))
    measured("phase 11 (b): two ranks on one card (gloo)",
             f"world {world_s:.1f} s; data-parallel step, 36 clouds a rank, patch rows {PARALLEL_A2A} from both: total "
             f"{dp['total']:.6f} (single {dp['single total']:.6f}, rel err {dp['rel']:.3g}), parameters max abs err "
             f"{dp['params']:.3g}, statistics {dp['stats']:.3g} (SGD, deterministic algorithms), "
             f"{ms['dp step']:.2f} ms per step; sharded eval B={PARALLEL_EVAL_BATCH}: descriptors max abs err "
             f"{ev['desc']:.3g}, local {ev['local']:.3g}, centres equal, {ms['sharded eval']:.2f} ms per batch "
             f"({PARALLEL_EVAL_BATCH / ms['sharded eval'] * 1e3:.1f} descriptors/s) against "
             f"{ms['eval single']:.2f} ms single ({PARALLEL_EVAL_BATCH / ms['eval single'] * 1e3:.1f} descriptors/s)")
    measured(f"phase 11 (b): point-axis sharding over two ranks, B={B} clouds of {N_POINTS} points",
             f"sharded_knn k=20 indices and d2 equal to K2's, {ms['sharded_knn']:.2f} ms per call against "
             f"{ms['knn single']:.3f} ms; sharded_fps m={PATCH_LEVELS[0]} indices equal to K1's, "
             f"{ms['sharded_fps']:.1f} ms per level against {ms['fps single']:.3f} ms; PatchAugNet descriptors "
             f"max abs err {c['sharded patchaugnet']['desc']:.3g}, {ms['sharded patchaugnet']:.2f} ms against "
             f"{ms['patchaugnet single']:.2f} ms; PPT-Net {c['sharded pptnet']['desc']:.3g}, "
             f"{ms['sharded pptnet']:.2f} ms against {ms['pptnet single']:.2f} ms; PPT-Net sharded step total "
             f"rel err {pp['rel']:.3g}, gradients leaf by leaf in relative L2 at most {pp['leaf err']:.3g} "
             f"({pp['worst leaf']}; leaves above 1e-5: {pp['leaves above 1e-5']}), parameters {pp['params']:.3g} "
             f"(largest update {pp['update']:.3g}), statistics {pp['stats']:.3g}, operations without a deterministic "
             f"implementation {pp['nondeterministic ops']}, "
             f"{ms['sharded pptnet step']:.1f} ms for the step (deterministic algorithms); launches per rank "
             + ", ".join(f"{k} {v}" for k, v in ranks[0]["counts"].items()))

    # (c) the CLIs at --devices 2 on the shared card
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".parallel_cli_") as exp:
        t0 = time.perf_counter()
        run = train_torch.main(["--config", CLI_CONFIG, "--dataset", "synthetic", "--epochs", "1", "--max-batches",
                                "1", "--devices", "2", "--share-device", "--exp_dir", exp])
        train_s = time.perf_counter() - t0
        models = [r["model"] for r in run["ranks"]]
        if not all(torch.equal(v, models[1][k]) and torch.isfinite(v.float()).all() for k, v in models[0].items()):
            raise AssertionError("train_torch.py --devices 2: the ranks' models differ or are not finite")
        loss = run["summaries"][0]["total"]
        if not np.isfinite(loss):
            raise AssertionError(f"train_torch.py --devices 2: total {loss}")
        argv = ["--config", CLI_CONFIG, "--dataset", "synthetic", "--exp_dir", exp, "--no_save_top_k"]
        t0 = time.perf_counter()
        two = evaluate_torch.main(argv + ["--devices", "2", "--share-device"])
        eval_s = time.perf_counter() - t0
        one = evaluate_torch.main(argv)
        scene = one["test_ds"].scene
        err = float(np.abs(two["global_descs"] - scene.global_descs).max())
        if err > PARALLEL_DESC_TOL or not np.array_equal(two["global_descs"], two["ranks"][1]["global_descs"]):
            raise AssertionError(f"evaluate_torch.py --devices 2: descriptors max abs err {err} against --devices 1, "
                                 f"or the ranks' differ")
        # recall@1 may differ only where a query's two nearest records are
        # a tie within what the descriptors' difference can swap
        from patchaugnet_tpu_torch.data import retrieval

        flips = top1_flips(np, retrieval, scene, scene.global_descs, two["global_descs"], dev)
        tie = tie_bound(err, scene.global_descs.shape[1])
        if any(gap > tie for *_, gap in flips) or (not flips and two["recall_at_1"] != one["recall_at_1"]):
            raise AssertionError(f"evaluate_torch.py --devices 2: recall@1 {two['recall_at_1']} against "
                                 f"{one['recall_at_1']}, first neighbours that differ {flips} (ties within {tie:.3g})")
    measured("phase 11 (c): the CLIs at --devices 2 --share-device",
             f"train_torch.py one batch of {run['cfg']['TRAIN_BATCH_SIZE']} tuples over two ranks: total {loss:.6f}, "
             f"the ranks' models equal, {train_s:.1f} s; evaluate_torch.py: descriptors max abs err {err:.3g} against "
             f"--devices 1, recall@1 {two['recall_at_1']} (--devices 1: {one['recall_at_1']}); first neighbours that "
             f"differ (query, --devices 1's, --devices 2's, the gap of their squared distances) {flips}, each a tie "
             f"within {tie:.3g}; {eval_s:.1f} s")
    say(f"phase 11 (parallel): {time.perf_counter() - t_phase:.1f} s")
    return paths


# phase 12: the device-side remainder (ops, losses, nn/extras.py) at full width
EXTRAS_NSAMPLE = 20                           # SA0's kNN and ball size (configs/patch_aug_net.yaml)
EXTRAS_RADIUS = 0.1                           # about 17 of 4096 uniform points in the ball: some short, some over-full
EXTRAS_FEATURES = 64                          # feature width of the grouped point features
LABEL_CLASSES = 13
MINED_DESCRIPTORS, MINED_TUPLE = 72, 18       # the flagship step's descriptors and its tuples of 18
DESC_DIM = 256
POSE_POINTS, POSE_NEGATIVES = 128, 8          # ot_loss / pps_loss point sets (the SA1 centres) and candidates per row
EXTRAS_L, EXTRAS_D = 128, 256                 # the extras' positions (the SA1 centres) and d_model
CBAM_L = 1024                                 # CBAM and SE over the SA0 centres
EXTRAS_REPS = 10                              # timed calls per piece
LOSS_RTOL, LOSS_GRAD_RTOL, LOSS_GRAD_ATOL = 1e-5, 1e-5, 1e-6   # the CPU suite's (tests/test_torch_losses_extra.py)
EXTRAS_TOL = 5e-5                             # nn extras, card against CPU, absolute (measured 8.8e-6 at d_model 256)
FLOAT_GRAD_RTOL = 1e-5                        # featuregather's scatter-add backward against its largest value
                                              # (the card's atomics add in another order)


def to_cpu(tree):
    """A tensor, or every tensor of a tuple or list of them, on the CPU."""
    if isinstance(tree, (tuple, list)):
        items = [to_cpu(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree.detach().cpu() if hasattr(tree, "detach") else tree


def max_err(torch, a, b):
    """Largest absolute difference over matching tensors of two results (0
    for equal integer tensors; inf where an integer tensor differs)."""
    a, b = to_cpu(a), to_cpu(b)
    if isinstance(a, (tuple, list)):
        return max(max_err(torch, x, y) for x, y in zip(a, b, strict=True))
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} against {tuple(b.shape)}")
    if not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else float("inf")
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


class ExtrasRun:
    """Phases 12 and 13's bookkeeping: each piece run on the card (counted),
    timed, and held against the same port code on the CPU from the same
    inputs (and, where K2 is on its path, against the plain kernels on the
    card)."""

    def __init__(self, torch, mods, records, phase=12):
        self.torch, self.mods, self.records, self.phase = torch, mods, records, phase
        self.paths, self.lines = [], []

    def piece(self, name, fn, args, tol=0.0, knn=0, bn_relu=0):
        """``fn(*args)`` on the card, K2 launched ``knn`` times, the fused
        eval BatchNorm + ReLU ``bn_relu`` times, and nothing else; equal
        (``tol`` 0) or within ``tol`` of ``fn`` on the CPU on the same inputs
        and, where a kernel is on the path, of the card run under
        ``plain_kernels``. Returns the card's result."""
        torch = self.torch
        with torch.no_grad():
            got, counts, _ = counted(torch, self.mods, self.records, lambda: fn(*args))
        check_launches(counts, {"knn": knn, "bn_relu": bn_relu}, f"phase {self.phase} {name}")
        self.paths.append(counts)
        with torch.no_grad():
            cpu = fn(*to_cpu(args))
        err = max_err(torch, got, cpu)
        if err > tol:
            raise AssertionError(f"phase {self.phase} {name}: card against CPU max abs err {err} (allowed {tol})")
        text = f"card against CPU {'equal' if err == 0 else f'max abs err {err:.3g}'}"
        if knn or bn_relu:
            with torch.no_grad(), plain_kernels(self.mods):
                before = read_counts(self.mods, self.records)
                ref = fn(*args)
                if read_counts(self.mods, self.records) != before:
                    raise AssertionError(f"phase {self.phase} {name}: the plain run launched a kernel")
            perr = max_err(torch, got, ref)
            if perr > tol:
                raise AssertionError(f"phase {self.phase} {name}: kernels against plain kernels max abs err {perr}")
            text += f", against the plain kernels {'equal' if perr == 0 else f'{perr:.3g}'}"
        with torch.no_grad():
            ms = time_ms(torch, lambda: fn(*args), EXTRAS_REPS)
        fused = f", bn_relu {bn_relu}" if bn_relu else ""
        self.lines.append(f"{name} {ms:.4f} ms, K2 {counts['knn']}{fused}, {text}")
        return got

    def grad_piece(self, name, fn, floats, others, stats_keys=()):
        """A loss ``fn(*floats, *others)`` (or ``(loss, stats)``) forward
        and backward on the card against the CPU: the value and float
        statistics within ``LOSS_RTOL``, integer statistics equal, the
        gradients of every tensor in ``floats`` within ``LOSS_GRAD_RTOL``
        relative plus ``LOSS_GRAD_ATOL``; no kernel launched."""
        torch = self.torch

        def run(fl, ot):
            leaves = [f.detach().clone().requires_grad_(True) for f in fl]
            out = fn(*leaves, *ot)
            loss, stats = out if isinstance(out, tuple) else (out, {})
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in stats.items()}, [x.grad for x in leaves]

        (loss, stats, grads), counts, _ = counted(torch, self.mods, self.records, lambda: run(floats, others))
        check_launches(counts, {}, f"phase {self.phase} {name}")
        self.paths.append(counts)
        c_loss, c_stats, c_grads = run(to_cpu(floats), to_cpu(others))
        rel = abs(loss.item() - c_loss.item()) / max(abs(c_loss.item()), 1e-30)
        bad = [k for k, v in stats.items()
               if (v.is_floating_point() and abs(v.item() - c_stats[k].item()) > LOSS_RTOL * abs(c_stats[k].item()))
               or (not v.is_floating_point() and v.item() != c_stats[k].item())]
        # each gradient element's error beyond its relative allowance
        excess = max(((g.cpu().double() - c.double()).abs() - LOSS_GRAD_RTOL * c.double().abs()).max().item()
                     for g, c in zip(grads, c_grads))
        if rel > LOSS_RTOL or bad or excess > LOSS_GRAD_ATOL or not torch.isfinite(loss):
            raise AssertionError(f"phase {self.phase} {name}: loss {loss.item()} against CPU {c_loss.item()} "
                                 f"(rel {rel}), statistics differing {bad}, gradient error beyond {LOSS_GRAD_RTOL} "
                                 f"relative {excess} (allowed {LOSS_GRAD_ATOL})")
        ms = time_ms(torch, lambda: run(floats, others), EXTRAS_REPS)
        gmax = max((g.cpu() - c).abs().max().item() for g, c in zip(grads, c_grads))
        self.lines.append(f"{name} {ms:.4f} ms forward and backward, loss {loss.item():.6g} (rel err {rel:.3g}), "
                          f"gradients max abs err {gmax:.3g}")


def extras_point_ops(torch, ops, run, dev):
    """The remaining point ops at the flagship's SA0 shapes."""
    gen = torch.Generator(device=dev).manual_seed(70)
    xyz = torch.rand(B, N_POINTS, 3, generator=gen, device=dev)
    xyz[:, 9::9] = xyz[:, :1]                              # duplicates: ties in the kNN and the ball
    centers = ops.farthest_point_sample(xyz, PATCH_LEVELS[0])   # K1, outside the counted runs
    new_xyz = ops.gather(xyz, centers)
    feats = torch.randn(B, N_POINTS, EXTRAS_FEATURES, generator=gen, device=dev)
    cfeat = ops.gather(feats, centers)
    k, r = EXTRAS_NSAMPLE, EXTRAS_RADIUS

    fill = (ops.pairwise_sqdist(new_xyz, xyz) < r * r).sum(-1)
    shares = {"empty": (fill == 0).float().mean().item(), "short": ((fill > 0) & (fill < k)).float().mean().item(),
              "full": (fill == k).float().mean().item(), "over-full": (fill > k).float().mean().item()}
    if not (shares["short"] > 0 and shares["over-full"] > 0):
        raise AssertionError(f"phase 12: radius {r} leaves no short or no over-full query: {shares}")
    del fill
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.ball_query(r, k, xyz, new_xyz)
    torch.cuda.synchronize()
    ball_mib = (torch.cuda.max_memory_allocated(dev) - base) / 2**20

    idx = run.piece("ball_query", lambda a, b: ops.ball_query(r, k, a, b), (xyz, new_xyz))
    run.piece("knn_exclude_self", lambda a, b: ops.knn_exclude_self(a, b, k), (xyz, new_xyz), knn=1)
    run.piece("self_sqdist", ops.self_sqdist, (new_xyz,))
    qge = ops.query_and_group_edge
    forms = {
        "query_and_group_edge kNN (dilation 2)": (lambda *a: qge(*a, nsample=k, knn_dilation=2), 1),
        "query_and_group_edge radius": (lambda *a: qge(*a, nsample=k, radius=r), 0),
        "query_and_group_edge idx": (lambda a, b, f, c, i: qge(a, b, f, c, nsample=k, idx=i), 0),
        "query_and_group_edge xyz only": (lambda a, b, f, c: qge(a, b, None, None, nsample=k), 1),
        "query_and_group_edge no xyz, radius": (lambda *a: qge(*a, nsample=k, radius=r, use_xyz=False), 0),
    }
    for name, (fn, knn) in forms.items():
        run.piece(name, fn, (xyz, new_xyz, feats, cfeat) + ((idx,) if name.endswith("idx") else ()), knn=knn)
    # the shuffle draws from a generator on each device: held as the set of
    # neighbours per row and as a seeded draw repeated
    shuffled = [qge(xyz, new_xyz, feats, cfeat, nsample=k, knn_dilation=2,
                    generator=torch.Generator(device=dev).manual_seed(s)).sample_idx for s in (1, 1)]
    plain_idx = qge(xyz, new_xyz, feats, cfeat, nsample=k, knn_dilation=2).sample_idx
    if not (torch.equal(shuffled[0], shuffled[1])
            and torch.equal(shuffled[0].sort(-1).values, plain_idx.sort(-1).values)):
        raise AssertionError("phase 12: the shuffled kNN grouping is not a seeded permutation of the kNN's")
    run.piece("query_and_group kNN", lambda a, b, f: ops.query_and_group(a, b, f, nsample=k), (xyz, new_xyz, feats),
              knn=1)
    run.piece("query_and_group radius", lambda a, b, f: ops.query_and_group(a, b, f, nsample=k, radius=r),
              (xyz, new_xyz, feats))
    run.piece("group_all", ops.group_all, (xyz, feats))

    labels = torch.randint(0, LABEL_CLASSES, (B, N_POINTS), generator=gen, device=dev)
    label_stat = torch.nn.functional.one_hot(labels, LABEL_CLASSES).to(torch.int32)
    run.piece("labelstat_ballrange", lambda a, b, s: ops.labelstat_ballrange(r, a, b, s), (xyz, new_xyz, label_stat))
    run.piece("labelstat_and_ballquery", lambda a, b, s: ops.labelstat_and_ballquery(r, k, a, b, s),
              (xyz, new_xyz, label_stat))
    run.piece("labelstat_idx", ops.labelstat_idx, (label_stat, idx))
    dist_idx = run.piece("featuredistribute", ops.featuredistribute, (new_xyz, xyz))
    run.piece("featuregather", ops.featuregather, (cfeat, dist_idx))
    # featuregather's backward: the gather's scatter-add (atomics on the card)
    weight = torch.randn(B, N_POINTS, EXTRAS_FEATURES, generator=gen, device=dev)
    grads = []
    for dv in (dev, torch.device("cpu")):
        leaf = cfeat.to(dv).clone().requires_grad_(True)
        (ops.featuregather(leaf, dist_idx.to(dv)) * weight.to(dv)).sum().backward()
        grads.append(leaf.grad.cpu())
    gerr = (grads[0] - grads[1]).abs().max().item() / grads[1].abs().max().item()
    if gerr > FLOAT_GRAD_RTOL:
        raise AssertionError(f"phase 12 featuregather backward: card against CPU max abs err {gerr} of the largest")
    measured(f"phase 12 (ops): B={B}, {N_POINTS} points, {PATCH_LEVELS[0]} centres, nsample {k}, radius {r}",
             f"ball fill shares {', '.join(f'{key} {v:.4f}' for key, v in shares.items())}; ball_query's peak "
             f"{ball_mib:.1f} MiB above its inputs (the (b, m, n) distances and int32 score, 512 MiB each); "
             f"featuregather backward max abs err {gerr:.3g} of its largest value; " + "; ".join(run.lines))
    run.lines.clear()


def extras_losses(torch, losses, run, dev):
    """The miners at the flagship step's 72 descriptors, the quadruplet
    form, the pose-estimation losses over 128 x 128 point sets, the
    multi-similarity and focal losses."""
    gen = torch.Generator(device=dev).manual_seed(71)
    n = MINED_DESCRIPTORS
    emb = torch.nn.functional.normalize(torch.randn(n, DESC_DIM, generator=gen, device=dev), dim=-1)
    tup = torch.arange(n, device=dev) // MINED_TUPLE
    slot = torch.arange(n, device=dev) % MINED_TUPLE
    pos = (tup[:, None] == tup[None, :]) & (slot[None, :] < 3) & ~torch.eye(n, dtype=torch.bool, device=dev)
    neg = tup[:, None] != tup[None, :]
    run.grad_piece("batch_hard_triplet_loss", losses.batch_hard_triplet_loss, [emb], [pos, neg])
    run.grad_piece("batch_hard_contrastive_loss", losses.batch_hard_contrastive_loss, [emb], [pos, neg])
    q, p, ng, other = (emb.reshape(4, MINED_TUPLE, DESC_DIM)[:, a:b] for a, b in ((0, 1), (1, 3), (3, 17), (17, 18)))
    run.grad_piece("contrastive_quadruplet_loss",
                   lambda *a: losses.contrastive_quadruplet_loss(*a, 0.5, 0.2), [q, p, ng, other], [])

    m = POSE_POINTS
    scores = torch.randn(B, m + 1, m + 1, generator=gen, device=dev)
    pair_idx = torch.stack([torch.randperm(m, generator=gen, device=dev).expand(B, m),
                            torch.randint(0, m, (B, m), generator=gen, device=dev)], -1).int()
    pair_valid = torch.rand(B, m, generator=gen, device=dev) < 0.5
    unpair = torch.randint(0, m, (2, B, m), generator=gen, device=dev).int()
    u_valid = torch.rand(2, B, m, generator=gen, device=dev) < 0.5
    run.grad_piece("ot_loss", losses.ot_loss, [scores],
                   [pair_idx, pair_valid, unpair[0], u_valid[0], unpair[1], u_valid[1]])
    src = torch.randn(B, m, DESC_DIM, generator=gen, device=dev)
    tgt = torch.randn(B, m, DESC_DIM, generator=gen, device=dev)
    neg_idxs = torch.randint(0, m, (B, m, 2 + POSE_NEGATIVES), generator=gen, device=dev).int()
    neg_valid = torch.rand(B, m, generator=gen, device=dev) < 0.8
    run.grad_piece("pps_loss", losses.pps_loss, [src, tgt], [neg_idxs, neg_valid])
    apn = emb.reshape(3, 4, 6, DESC_DIM)
    run.grad_piece("multi_similarity_loss", losses.multi_similarity_loss, [apn[0], apn[1], apn[2]], [])
    logits = torch.randn(n, LABEL_CLASSES, generator=gen, device=dev)
    target = torch.randint(0, LABEL_CLASSES, (n,), generator=gen, device=dev)
    run.grad_piece("focal_loss", losses.focal_loss, [logits], [target])
    run.grad_piece("binary_focal_loss", lambda x, t: losses.binary_focal_loss(x, t, with_logit=True), [logits],
                   [torch.rand(n, LABEL_CLASSES, generator=gen, device=dev) < 0.3])
    measured(f"phase 12 (losses): {n} descriptors of {DESC_DIM} (tuples of {MINED_TUPLE}); pose sets {B} x {m} x "
             f"{m}, {POSE_NEGATIVES} candidates per row", "; ".join(run.lines))
    run.lines.clear()


def extras_blocks(torch, nn, run, dev):
    """``nn/extras.py`` at d_model 256 over 128 positions, B=32, eval mode,
    on seeded weights copied to the CPU."""
    gen = torch.Generator(device=dev).manual_seed(72)
    cfg = {"embed_dim": EXTRAS_D, "local_dim": EXTRAS_D, "global_dim": EXTRAS_D, "num_local": EXTRAS_L,
           "cluster_size": 64, "use_geo_encoder": True, "geo_encode_type": "dist_and_angle", "angle_k": 3,
           "add_or_cat": "cat", "use_vlad": True, "layer_names": ["self", "cross", "self", "cross"],
           "use_pool": True, "pool": "gem"}

    def inputs():
        return (torch.randn(B, EXTRAS_D, generator=gen, device=dev),
                torch.randn(B, EXTRAS_L, EXTRAS_D, generator=gen, device=dev),
                torch.rand(B, EXTRAS_L, 3, generator=gen, device=dev))

    def on_both(module, seed):
        """A seeded module on the card, and a copy of it on the CPU, both in
        eval mode: ``fn(*args)`` runs the copy whose device the args are on."""
        module = nn.seeded_init_(module, torch.Generator().manual_seed(seed)).eval()
        cpu = copy.deepcopy(module)
        module.to(dev)
        return lambda *a: (module if a[0].is_cuda else cpu)(*a)

    single = on_both(nn.SingleFeatProcessor(cfg), 73)
    run.piece("SingleFeatProcessor (dist + angle, NetVLAD, self/cross x 2)", single, inputs(), tol=EXTRAS_TOL, knn=1)
    pair = on_both(nn.PairwiseFeatProcessor(cfg), 74)
    run.piece("PairwiseFeatProcessor", pair, inputs() + inputs(), tol=EXTRAS_TOL, knn=2)
    x = torch.randn(B, EXTRAS_L, EXTRAS_D, generator=gen, device=dev)
    pos = torch.randn(B, EXTRAS_L, EXTRAS_D, generator=gen, device=dev)
    for k in (None, 64):
        layer = on_both(nn.TransformerEncoderLayer(EXTRAS_D, 4, 2048, linear_attention_k=k, seq_len=EXTRAS_L), 75)
        run.piece(f"TransformerEncoderLayer (nhead 4, ff 2048, linear_attention_k {k})", layer, (x, pos),
                  tol=EXTRAS_TOL)
    wide = torch.rand(B, CBAM_L, EXTRAS_D, generator=gen, device=dev)
    run.piece("CBAM", on_both(nn.CBAM(EXTRAS_D), 76), (wide,), tol=EXTRAS_TOL, bn_relu=1)
    run.piece("SEAttention", on_both(nn.SEAttention(EXTRAS_D), 77), (wide,), tol=EXTRAS_TOL)
    measured(f"phase 12 (nn extras): B={B}, {EXTRAS_L} positions, d_model {EXTRAS_D}; CBAM and SE over "
             f"({B}, {CBAM_L}, {EXTRAS_D})", "; ".join(run.lines))
    run.lines.clear()


def phase_extras(torch, ops, mods, records, dev):
    """Phase 12: the remaining point ops, the miners and auxiliary losses,
    and ``nn/extras.py`` at full width, each against the same port code on
    the CPU (and the plain kernels where K2 is on its path). Returns every
    run's launch counts."""
    from patchaugnet_tpu_torch import losses, nn

    t_phase = time.perf_counter()
    run = ExtrasRun(torch, mods, records)
    extras_point_ops(torch, ops, run, dev)
    extras_losses(torch, losses, run, dev)
    extras_blocks(torch, nn, run, dev)
    say(f"phase 12 (extras): {time.perf_counter() - t_phase:.1f} s")
    return run.paths


# phase 13: the host-side remainder
HOST_POINTS = N_POINTS                        # the FPFH, ICP and scene clouds
FPFH_RADIUS, FPFH_MAX_NN = 0.05, (30, 100)    # the reference's get_fpfh defaults (scene_dataset.py:756-780)
FPFH_GROUP_TOL = 1e-9                         # native against numpy: every row's 11-bin group sums
FPFH_EXACT_ROWS, FPFH_MOVED_MASS = 0.85, 0.02   # and tests/test_fpfh.py's share of exact rows and mass moved
FPFH_NATIVE_REPS = 5                          # timed native calls (one numpy call: seconds)
HOST_TRIPS = ("2014-11-14-16-34-33", "2014-11-18-13-20-12")   # two of Oxford's trips (train and test splits)
HOST_TRAIN_PER_TRIP, HOST_TEST_PER_TRIP = 24, 4   # submaps per trip: train split, test split (in the test box)
HOST_OFFSET = (5730000.0, 620000.0)           # the train submaps' (northing, easting) origin, off Oxford's test box
HOST_TEST_XY = (5735237.0, 620543.0)          # a vertex of Oxford's test region (dataset_info.py)
HOST_CLI_BATCHES = 2                          # train_torch.py batches on the file-backed scene
ICP_DEGREES, ICP_SHIFT = 5.0, (0.05, -0.03, 0.02)   # the known rigid transform between the two clouds
ICP_TOL = 1e-9                                # the recovered transform against it, elementwise
OVERLAP_DIST = 0.02                           # get_overlap_indices' max_dist on the normalised clouds
ANGLE_M, ANGLE_K = 128, 3                     # nn_angle over the SA1 centres, k as the AngleEncoder's
ANGLE_TOL = 1e-5                              # nn_angle's cosines, card against CPU (f32; measured equal on the CPU)
HOST_REPS = 5                                 # timed host calls


class ImportWatch:
    """Records every attempt to import ``name`` (or a submodule of it) while
    it is active, by a meta path finder placed first, and makes the attempt
    fail (``ModuleNotFoundError``), as on a machine without the package.
    The first attempt's stack is kept for the report."""

    def __init__(self, name):
        self.name, self.attempts, self.first_stack = name, [], None

    def find_spec(self, fullname, path=None, target=None):
        if fullname == self.name or fullname.startswith(self.name + "."):
            if not self.attempts:
                import traceback

                self.first_stack = "".join(traceback.format_stack(limit=12))
            self.attempts.append(fullname)
            raise ModuleNotFoundError(f"{fullname} is blocked in this run", name=fullname)
        return None

    def __enter__(self):
        sys.meta_path.insert(0, self)
        return self

    def __exit__(self, *exc):
        sys.meta_path.remove(self)


def host_fpfh(np):
    """Both host libraries built with this machine's g++; FPFH native and
    numpy on one 4096-point submap cloud at the reference's defaults."""
    from patchaugnet_tpu_torch.data import fpfh, fpfh_native, pointclouds
    from patchaugnet_tpu_torch.ops.cuda import _host_build

    t0 = time.perf_counter()
    built = {name: _host_build.build(name) for name in _host_build.LIBRARIES}
    build_s = time.perf_counter() - t0
    cloud = pointclouds.synthetic_scene_clouds(np.random.RandomState(80), 1, HOST_POINTS)[0].astype(np.float64)
    args = (cloud, FPFH_RADIUS, FPFH_RADIUS, *FPFH_MAX_NN)
    native = fpfh_native.compute_fpfh_native(*args)
    t0 = time.perf_counter()
    for _ in range(FPFH_NATIVE_REPS):
        fpfh_native.compute_fpfh_native(*args)
    native_ms = (time.perf_counter() - t0) / FPFH_NATIVE_REPS * 1e3
    t0 = time.perf_counter()
    plain = fpfh.compute_fpfh(*args, use_native=False)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    if fpfh.compute_fpfh(*args).tobytes() != native.tobytes():
        raise AssertionError("phase 13: compute_fpfh's default route is not the native one")
    group = np.abs(plain.reshape(-1, 3, 11).sum(-1) - native.reshape(-1, 3, 11).sum(-1)).max()
    diff = np.abs(plain - native)
    exact = float((diff.max(1) <= FPFH_GROUP_TOL).mean())
    moved = float(diff.sum() / plain.sum())
    if not (group <= FPFH_GROUP_TOL and exact >= FPFH_EXACT_ROWS and moved <= FPFH_MOVED_MASS):
        raise AssertionError(f"phase 13 FPFH: native against numpy, group sums differ by {group} (allowed "
                             f"{FPFH_GROUP_TOL}), {exact:.4f} of rows exact, {moved:.4g} of the mass moved")
    _, valid, _ = fpfh._hybrid_neighbors(cloud, FPFH_RADIUS, FPFH_MAX_NN[1])
    measured(f"phase 13 FPFH, a {HOST_POINTS}-point submap cloud (unit sphere), radius {FPFH_RADIUS}, max_nn "
             f"{FPFH_MAX_NN[0]}/{FPFH_MAX_NN[1]}, {valid.sum(1).mean():.2f} neighbours per point on average",
             f"native {native_ms:.3f} ms per cloud ({os.cpu_count()} host cores), numpy {numpy_ms:.1f} ms per "
             f"cloud; native against numpy: group sums max abs diff {group:.3g} (allowed {FPFH_GROUP_TOL}), "
             f"{exact:.4f} of rows equal within it, {moved:.4g} of the mass moved by boundary flips (elementwise "
             f"max {diff.max():.4g}); both libraries built with g++ in {build_s:.1f} s into "
             f"{os.path.dirname(built['fpfh'])}")
    return native_ms, numpy_ms


def host_scene(np, root):
    """Two Oxford-format trips of float64 ``.bin`` clouds under ``root``: the
    train split is the synthetic scene's layout (each location a close pair
    of submaps, revisited by the other trip), the test split a few submaps
    in Oxford's test box."""
    from patchaugnet_tpu_torch.data import SceneDataset

    synth = SceneDataset("synthetic", for_training=True, device="cpu")
    synth.create_synthetic(n_trips=len(HOST_TRIPS), n_per_trip=HOST_TRAIN_PER_TRIP, num_points=HOST_POINTS)
    rng = np.random.RandomState(83)
    for t, trip in enumerate(HOST_TRIPS):
        rows = range(t * HOST_TRAIN_PER_TRIP, (t + 1) * HOST_TRAIN_PER_TRIP)
        splits = {"pointcloud_20m_10overlap": [(1400000000000000 + 1000 * i + t, synth.records.northing[r]
                                                + HOST_OFFSET[0], synth.records.easting[r] + HOST_OFFSET[1],
                                                synth._clouds[r]) for i, r in enumerate(rows)],
                  "pointcloud_20m": [(1500000000000000 + 1000 * i + t, HOST_TEST_XY[0] + 3.0 * i,
                                      HOST_TEST_XY[1] + t, synth._clouds[i]) for i in range(HOST_TEST_PER_TRIP)]}
        for submap_type, submaps in splits.items():
            cloud_dir = os.path.join(root, "oxford", trip, submap_type)
            os.makedirs(cloud_dir)
            with open(cloud_dir + ".csv", "w") as f:
                f.write("timestamp,northing,easting\n")
                for stamp, north, east, cloud in submaps:
                    f.write(f"{stamp},{north:.6f},{east:.6f}\n")
                    cloud.astype(np.float64).tofile(os.path.join(cloud_dir, f"{stamp}.bin"))
    return rng


def host_cli(torch, np, mods, records, root):
    """``create_dataset_torch.py`` on the file-backed scene, the .pb overlap
    records written, then ``train_torch.py`` for two batches with the patch
    losses on: clouds through the native loader, overlaps from the .pb."""
    import create_dataset_torch
    import train_torch
    from patchaugnet_tpu_torch import train
    from patchaugnet_tpu_torch.data import SceneDataset, fast_loader, save_overlap_pb, synthetic_overlaps

    rng = host_scene(np, root)
    t0 = time.perf_counter()
    create_dataset_torch.main(["--datasets", "oxford"])
    create_s = time.perf_counter() - t0
    scene = SceneDataset("oxford", for_training=True, device="cpu")
    if not scene.load() or len(scene) != len(HOST_TRIPS) * HOST_TRAIN_PER_TRIP:
        raise AssertionError(f"phase 13: the created train split holds {len(scene)} records")
    scene.native_loader = False                           # the numpy route, for the overlaps and the check below
    t0 = time.perf_counter()
    pb_files = entries = 0
    for q in sorted(set().union(*scene.valid_indices_list)):
        positives = scene.get_tuple(q).positive_indices
        clouds, _ = scene.get_clouds([q, *positives], normalize=False)
        per = {p: synthetic_overlaps(clouds[0], c, rng=rng) for p, c in zip(positives, clouds[1:])}
        save_overlap_pb(os.path.join(scene.pickle_dir(), f"{scene.dataset_type}_overlap_indices_{q}.pb"), per,
                        query_idx=q)
        pb_files += 1
        entries += sum(len(v) for v in per.values())
    pb_s = time.perf_counter() - t0

    loads = []
    load_clouds = fast_loader.load_clouds

    def counted_load(paths, *args, **kwargs):
        out = load_clouds(paths, *args, **kwargs)
        loads.append((list(paths), out[0], out[2]))
        return out

    fast_loader.load_clouds = counted_load
    clock = HostClock()
    clock.patch(train, "train_one_epoch", "epoch")
    try:
        reset_counts(mods, records)
        run = train_torch.main(["--config", os.path.join(ROOT, CLI_CONFIG), "--dataset", "oxford", "--epochs", "1",
                                "--max-batches", str(HOST_CLI_BATCHES), "--exp_dir", os.path.join(root, "train")])
        torch.cuda.synchronize()
        counts = read_counts(mods, records)
    finally:
        fast_loader.load_clouds = load_clouds
        clock.undo()
    summary = run["summaries"][0]
    if summary["batches"] != HOST_CLI_BATCHES or summary["patch_batches"] != HOST_CLI_BATCHES:
        raise AssertionError(f"phase 13 CLI: {summary['batches']} batches, {summary['patch_batches']} with overlap "
                             f"tables (want {HOST_CLI_BATCHES} of each)")
    per_batch = {k: CENTER_LAUNCHES.get(k, 0) + STEP_LAUNCHES.get(k, 0) for k in counts}
    check_launches(counts, {k: v * HOST_CLI_BATCHES for k, v in per_batch.items()}, "phase 13 CLI train")
    losses = {k: summary[k] for k in ("total", "place_recognition", "patch_recon_a2a", "patch_recon_a2b")}
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"phase 13 CLI: epoch losses {losses}")
    # the batches' clouds came through the native loader (each submap read
    # once, then served from the scene's cache), equal to the numpy route's
    files = [f for paths, _, _ in loads for f in paths]
    clouds_per_batch = run["cfg"]["TRAIN_BATCH_SIZE"] * (2 + run["cfg"]["TRAIN_POSITIVES_PER_QUERY"]
                                                         + run["cfg"]["TRAIN_NEGATIVES_PER_QUERY"])
    if not files or len(set(files)) != len(files) or any(ok != len(paths) for paths, _, ok in loads):
        raise AssertionError(f"phase 13 CLI: the native loader read {len(files)} files ({len(set(files))} distinct) "
                             f"in {len(loads)} calls, not all of them whole")
    index = {f: i for i, f in enumerate(scene.records.file)}
    want, _ = scene.get_clouds([index[f] for f in files], normalize=False)
    if not np.array_equal(np.concatenate([c for _, c, _ in loads]), want):
        raise AssertionError("phase 13 CLI: the native loader's clouds differ from the numpy route's")
    epoch_ms = clock.seconds["epoch"] * 1e3
    measured(f"phase 13 CLI on a file-backed Oxford-format scene ({len(scene)} train submaps of {HOST_POINTS} "
             f"float64 points, {pb_files} .pb overlap files, {entries} entries)",
             f"create_dataset_torch.py {create_s:.2f} s, .pb records written in {pb_s:.2f} s; train_torch.py "
             f"{HOST_CLI_BATCHES} batches of {clouds_per_batch} clouds with the patch losses: the epoch "
             f"{epoch_ms:.1f} ms ({epoch_ms / HOST_CLI_BATCHES:.1f} ms per batch, the first batch's first calls "
             f"included); launches {counts} (K1 3 + 1 and K2 6 per batch); {len(files)} clouds through the native "
             f"loader in {len(loads)} calls, equal to the numpy route's; losses "
             f"{({k: round(v, 6) for k, v in losses.items()})}")
    return counts, epoch_ms


def host_geometry(torch, np, run, dev):
    """``utils.geometry``: ``nn_angle`` on the card (K2 once a call) against
    the CPU and the plain kernels; ``get_overlap_indices`` and ICP on two
    4096-point clouds related by a known rigid transform."""
    from patchaugnet_tpu_torch.data import pointclouds
    from patchaugnet_tpu_torch.utils import geometry

    gen = torch.Generator(device=dev).manual_seed(84)
    centres = torch.rand(B, ANGLE_M, 3, generator=gen, device=dev)
    run.piece(f"utils.geometry.nn_angle ({B}, {ANGLE_M}) k={ANGLE_K}",
              lambda c: torch.from_numpy(geometry.nn_angle(c.cpu().numpy(), ANGLE_K, device=c.device)),
              (centres,), tol=ANGLE_TOL, knn=1)
    src = pointclouds.synthetic_scene_clouds(np.random.RandomState(82), 1, HOST_POINTS)[0].astype(np.float64)
    truth = np.eye(4)
    truth[:3, :3] = geometry.rotation_matrix_z(np.radians(ICP_DEGREES))
    truth[:3, 3] = ICP_SHIFT
    tgt = geometry.apply_transform(src, truth)
    geometry.get_overlap_indices(src, tgt, OVERLAP_DIST)                  # scipy.spatial imported outside the timing
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        sets = geometry.get_overlap_indices(src, tgt, OVERLAP_DIST)
    overlap_ms = (time.perf_counter() - t0) / HOST_REPS * 1e3
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        found, rmse = geometry.icp_point_to_point(src, tgt)
    icp_ms = (time.perf_counter() - t0) / HOST_REPS * 1e3
    err = np.abs(found - truth).max()
    if err > ICP_TOL or not (0 < len(sets[0]) < HOST_POINTS and 0 < len(sets[1]) < HOST_POINTS):
        raise AssertionError(f"phase 13 ICP: transform max abs err {err} (allowed {ICP_TOL}); overlap sets of "
                             f"{len(sets[0])} and {len(sets[1])}")
    measured(f"phase 13 geometry, two {HOST_POINTS}-point submap clouds {ICP_DEGREES} deg about z and "
             f"{ICP_SHIFT} apart",
             f"get_overlap_indices (max_dist {OVERLAP_DIST}) {overlap_ms:.2f} ms, sets of {len(sets[0])} and "
             f"{len(sets[1])}; icp_point_to_point {icp_ms:.2f} ms, transform max abs err {err:.3g} (allowed "
             f"{ICP_TOL}), RRE {geometry.relative_rotation_error(found[:3, :3], truth[:3, :3]):.3g} deg, RTE "
             f"{geometry.relative_translation_error(found[:3, 3], truth[:3, 3]):.3g}, RMSE {rmse:.3g}; "
             + "; ".join(run.lines))
    run.lines.clear()
    return icp_ms


def host_trace(torch, mods, records, dev, root):
    """One B=32 flagship forward under ``utils.profiling.trace``: the Chrome
    trace names 3 K1, 6 K2 and 16 fused BatchNorm + ReLU launches, on the
    host and on the card."""
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_
    from patchaugnet_tpu_torch.utils import trace

    model = seeded_init_(get_model("patch_aug_net", configs.PATCH_AUG_NET), torch.Generator().manual_seed(0))
    forward = serving.build_forward_fn(model, device=dev)
    clouds = torch.rand(B, N_POINTS, 3, generator=torch.Generator(device=dev).manual_seed(85), device=dev)
    forward(clouds)
    torch.cuda.synchronize()
    reset_counts(mods, records)
    t0 = time.perf_counter()
    with trace(os.path.join(root, "trace"), device=dev) as prof:
        forward(clouds)
    traced_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts(mods, records)
    check_launches(counts, FORWARD_LAUNCHES, "phase 13 traced forward")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    host = {op: sum(e.get("name") == f"pan::{op}" for e in events) for op in FORWARD_LAUNCHES}
    # the kernels' names, demangled or not (``fps_registers<512, 8>``, ``...13fps_registersILi512...``)
    card = {op: sum(e.get("cat") == "kernel" and bool(re.search(pattern, e.get("name", ""))) for e in events)
            for op, pattern in (("fps", r"fps_(registers|scratch)"), ("knn", r"knn_kernel"),
                                ("bn_relu", r"bn_relu_kernel"))}
    if host != FORWARD_LAUNCHES or card != FORWARD_LAUNCHES:
        named = [(e.get("cat"), e.get("name", "")[:120]) for e in events
                 if any(op in e.get("name", "").lower() for op in FORWARD_LAUNCHES)]
        raise AssertionError(f"phase 13 trace: the host ops {host} and the card's kernels {card} (want "
                             f"{FORWARD_LAUNCHES} of each); events naming them: {named}")
    kernels = sum(e.get("cat") == "kernel" for e in events)
    measured(f"phase 13 utils.profiling.trace over one B={B} flagship forward",
             f"{os.path.getsize(prof.trace_path) / 2**20:.2f} MiB Chrome trace, {len(events)} events, {kernels} "
             f"kernels on the card; pan::fps {host['fps']}, pan::knn {host['knn']} and pan::bn_relu "
             f"{host['bn_relu']} on the host, K1 {card['fps']}, K2 {card['knn']} and bn_relu {card['bn_relu']} on "
             f"the card; {traced_ms:.1f} ms traced (the export included)")
    return counts


def host_visualization():
    """``compare_pose_errors`` without matplotlib; a plot raises the
    ``ImportError`` that names it (where matplotlib is installed, the plot
    is drawn instead)."""
    import importlib.util
    import tempfile

    from patchaugnet_tpu_torch.utils import visualization

    summary = visualization.compare_pose_errors([(1.0, 0.1), (3.0, 0.3)], [(2.0, 0.2)], ("icp", "none"))
    if summary["icp"]["rre_mean"] != 2.0 or summary["none"]["n"] != 1:
        raise AssertionError(f"phase 13 compare_pose_errors: {summary}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plot_") as tmp:
        out = os.path.join(tmp, "recall.png")
        if importlib.util.find_spec("matplotlib") is None:
            try:
                visualization.plot_recall_curves({"a": [50.0, 60.0]}, out)
            except ImportError as e:
                if "matplotlib" not in str(e):
                    raise AssertionError(f"phase 13: the plot's ImportError does not name matplotlib: {e}") from e
                text = f"a plot raised ImportError({str(e)!r})"
            else:
                raise AssertionError("phase 13: a plot ran without matplotlib")
        else:
            visualization.plot_recall_curves({"a": [50.0, 60.0]}, out)
            if not os.path.getsize(out):
                raise AssertionError("phase 13: the plot wrote nothing")
            text = "matplotlib is installed here: the plot was drawn"
    say(f"phase 13 visualization: compare_pose_errors ran ({summary['icp']}); {text}")


# the fresh processes of phase 13 (argv: the checkout, "cli" or "trace",
# a scratch directory): the packages the card's machine lacks made
# unimportable, protobuf blocked and watched, then ``host_cli`` (the data
# root in that directory) or ``host_trace``; prints one JSON line with the
# launch counts, the protobuf imports tried, and which of the blocked
# packages this machine has installed
HOST_SCRIPT = r"""
import importlib, importlib.util, json, sys
root, what, scratch = sys.argv[1:4]
installed = {n: importlib.util.find_spec(n) is not None
             for n in ("google.protobuf", "tensorboard", "sklearn", "pandas", "yaml", "matplotlib")}
for name in ("pandas", "sklearn", "yaml", "matplotlib", "tensorboard", "jax", "jaxlib", "flax", "patchaugnet_tpu"):
    sys.modules[name] = None
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as cs
cs.CARD = cs.card_line()
mods = {n: importlib.import_module(f"patchaugnet_tpu_torch.ops.{n}") for n in ("fps", "knn", "norm")}
records = [cs.KernelRecord(n, m, "", "") for n, m in (("fps", "fps"), ("knn", "knn"), ("bn_relu", "norm"))]
with cs.ImportWatch("google.protobuf") as watch:
    if what == "cli":
        counts, _ = cs.host_cli(torch, np, mods, records, scratch)
    else:
        counts = cs.host_trace(torch, mods, records, torch.device("cuda"), scratch)
print(json.dumps({"counts": counts, "protobuf_tried": watch.attempts, "first_stack": watch.first_stack,
                  "installed": installed,
                  "protobuf_loaded": sorted(m for m in sys.modules if m.startswith("google.protobuf"))}))
"""


def run_fresh(what, scratch, env=None):
    """``HOST_SCRIPT`` for ``what`` in a fresh process; forwards its lines,
    fails if it failed or protobuf was imported or tried in it, and returns
    its report."""
    proc = subprocess.run([sys.executable, "-c", HOST_SCRIPT, ROOT, what, scratch], env=env, capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        say(line)
    if proc.returncode != 0:
        raise AssertionError(f"phase 13: the {what} process failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    report = json.loads(lines[-1])
    if report["protobuf_tried"] or report["protobuf_loaded"]:
        raise AssertionError(f"phase 13 {what}: google.protobuf was imported or tried ({report['protobuf_tried']}, "
                             f"loaded {report['protobuf_loaded']}), first from:\n{report['first_stack']}")
    return report


def phase_host(torch, mods, records, dev):
    """Phase 13: the host-side remainder; the CLI run and the traced forward
    each in a fresh process where protobuf cannot be imported. Returns the
    launch counts of its paths."""
    import tempfile

    import numpy as np

    from patchaugnet_tpu_torch.data import dataset_info

    t_phase = time.perf_counter()
    run = ExtrasRun(torch, mods, records, phase=13)
    host_fpfh(np)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as root:
        cli = run_fresh("cli", root, dict(os.environ, **{dataset_info.DATA_ROOT_ENV: root}))
        traced = run_fresh("trace", root)
    say(f"phase 13: google.protobuf never imported nor tried in the CLI and trace processes; this machine has "
        f"installed {cli['installed']} (made unimportable there)")
    host_geometry(torch, np, run, dev)
    host_visualization()
    cli_counts, trace_counts = ({rec.name: r["counts"].get(rec.name, 0) for rec in records} for r in (cli, traced))
    say(f"phase 13 (host remainder): {time.perf_counter() - t_phase:.1f} s")
    return [cli_counts, *run.paths, trace_counts]

# phase 14: training quality. The full-width recall-lift runs of
# bench_quality_torch.py, each gated as the JAX suite gates its family
# (tests/test_train.py:313-315, :390-392, :402-404): trained recall@1 at
# least 55 and at least init + 5, the smallest epoch total below a share of
# the first epoch's; the bf16-trained flagship within 5 points of the f32
# one (tests/test_train.py:1151-1154, one-sided there)
QUALITY_RUNS = (("patch_aug_net", "float32"), ("patch_aug_net", "bfloat16"), ("pptnet", "float32"),
                ("pointnet_vlad", "float32"))
QUALITY_MIN_RECALL, QUALITY_MIN_LIFT = 55.0, 5.0
QUALITY_LOSS_SHARE = {"patch_aug_net": 0.6, "pptnet": 0.7, "pointnet_vlad": 0.7}
QUALITY_BF16_BAND = 5.0
# (launches per train step, per patch batch's centres, per eval forward)
QUALITY_LAUNCHES = {"patch_aug_net": (STEP_LAUNCHES, CENTER_LAUNCHES, FORWARD_LAUNCHES),
                    "pptnet": (PPT_STEP_LAUNCHES, {}, PPT_LAUNCHES), "pointnet_vlad": ({}, {}, PNV_LAUNCHES)}
# MinkLoc3Dv2's SmoothAP runs (tests/test_minkloc.py:231-282, dense;
# tests/test_minkloc_sparse.py:518-567, sparse at step 0.1): 2 x 16
# synthetic submaps of 64 points, 40 steps of 8 clouds, AdamW at 1e-3
# (MultiStepLR at epoch 250 of 10 steps), decay 1e-4; trained recall@1 at
# least 85 and at least init + 20
MINK_QUALITY = dict(feature_size=64, output_dim=64, planes=[16, 32, 16, 8], layers=[1, 1, 1, 1], num_top_down=2,
                    conv0_kernel_size=5, block="ECABasicBlock", pooling="GeM", coordinates="cartesian",
                    normalize_embeddings=False)
MINK_QUALITY_PARAMS = {"dense": dict(MINK_QUALITY, grid_size=16),
                       "sparse": dict(MINK_QUALITY, quantization_step=0.1)}
MINK_QUALITY_STEPS, MINK_QUALITY_BATCH, MINK_QUALITY_POINTS = 40, 8, 64
MINK_QUALITY_MIN_RECALL, MINK_QUALITY_MIN_LIFT = 85.0, 20.0
# the deterministic probe (tests/torch_deterministic_probe.py), twice, each
# in a fresh process: identical lines, the trained recall at least its pin
# (the card's measured 95.83 less 5 points, rounded down as the JAX gate
# pinned 79.17 at 74; NVIDIA H100 80GB HBM3), the bf16 serving leg within
# 5 points of f32
PROBE_RUNS = 2
PROBE_RECALL_PIN = 90.0
PROBE_BF16_BAND = 5.0
# PointNet2SAModuleMSG at SA0's shapes: one kNN scale (20, dilation 2) and
# one ball scale (radius 0.1, 32), SA0's widths each, the xyz as features
MSG_NPOINT, MSG_NSAMPLES, MSG_RADII, MSG_DILATION = 1024, (20, 32), (None, 0.1), 2
MSG_WIDTHS = (32, 32, 64)
MSG_TOL = 1e-5
MSG_LAUNCHES = {"fps": 1, "knn": 1, "bn_relu": 6}   # 2 scales of 3 SharedMLP layers


def quality_family(torch, mods, records, dev, family, precision):
    """One full-width ``bench_quality_torch.run``, gated; returns its
    record and launch counts."""
    import bench_quality_torch as bq

    reset_counts(mods, records)
    result = bq.run(family, precision, dev, log=lambda line: say(f"  {line}"))
    torch.cuda.synchronize()
    counts = read_counts(mods, records)
    per_step, per_centres, per_forward = QUALITY_LAUNCHES[family]
    if precision == "bfloat16":
        per_forward = bf16_launches(per_forward)
    want = {k: result["steps"] * per_step.get(k, 0) + result["patch_batches"] * per_centres.get(k, 0)
            + result["eval_batches"] * per_forward.get(k, 0) for k in set(per_step) | set(per_forward)}
    check_launches(counts, want, f"phase 14 {family} {precision} quality run ({result['steps']} steps, "
                                 f"{result['patch_batches']} patch batches, {result['eval_batches']} eval batches)")
    say(bq.record_line(result))
    r0, r1, totals = result["recall_at_1_init"], result["recall_at_1_trained"], result["epoch_totals"]
    finite = all(math.isfinite(t) for t in totals) and all(torch.isfinite(p).all() for p in
                                                            result["state"].model.parameters())
    share = QUALITY_LOSS_SHARE[family]
    if not finite or r1 < QUALITY_MIN_RECALL or r1 < r0 + QUALITY_MIN_LIFT or min(totals) >= share * totals[0]:
        raise AssertionError(f"phase 14 {family} {precision}: recall@1 {r0:.2f} -> {r1:.2f} (needs >= "
                             f"{QUALITY_MIN_RECALL} and >= init + {QUALITY_MIN_LIFT}), epoch totals {totals} (the "
                             f"smallest must be below {share} x the first), finite {finite}")
    measured(f"phase 14 {family} {precision}",
             f"recall@1 {r0:.2f} -> {r1:.2f} over {len(totals)} epochs ({result['steps']} steps), "
             f"{result['ms_per_step']:.2f} ms per step (host clock: batch, tables, step), {result['seconds']:.1f} s; "
             f"launches {counts} (per step {per_step}, centres {per_centres}, per eval forward {per_forward})")
    del result["state"]
    return result, counts


def smoothap_quality(torch, dev, backend, steps=MINK_QUALITY_STEPS):
    """MinkLoc3Dv2's SmoothAP run on the ``backend`` config: recall@1 of
    the test scene before and after ``steps`` steps; returns (init,
    trained, losses, host ms per step)."""
    import random

    from patchaugnet_tpu_torch import data, serving, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import training_init_

    scenes = []
    for for_training in (True, False):
        scene = data.SceneDataset("synthetic", for_training=for_training, device=dev)
        scene.create_synthetic(n_trips=2, n_per_trip=16, num_points=MINK_QUALITY_POINTS)
        scenes.append(scene)
    train_scene, test_scene = scenes
    model = training_init_(get_model("minkloc3dv2", MINK_QUALITY_PARAMS[backend]), torch.Generator().manual_seed(0))
    step, tx = train.build_smoothap_train_step(model, train.multistep_schedule(1e-3, [250], steps_per_epoch=10),
                                               weight_decay=1e-4, positives_per_query=2)
    state = train.create_train_state(model, {}, device=dev, tx=tx)
    forward = serving.build_forward_fn(state.model, dev)

    def recall1():
        test_scene.make_descs(forward, batch_size=MINK_QUALITY_BATCH)
        res = test_scene.recall_precision_all(top_k=5)
        return float(sum(r.recall[0] for r in res.values()) / len(res))

    r_init = recall1()
    rng, losses = random.Random(0), []
    t0 = time.perf_counter()
    for _ in range(steps):
        bidx = train.sample_smoothap_batch(train_scene, MINK_QUALITY_BATCH, rng)
        pos, neg = train.build_masks(train_scene, bidx)
        clouds, _ = train_scene.get_clouds(bidx)
        state, stats = step(state, clouds, pos, neg)
        losses.append(stats["loss"])
    losses = [v.item() for v in losses]
    ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    return r_init, recall1(), losses, ms


PROBE = os.path.join("tests", "torch_deterministic_probe.py")


def quality_probe():
    """The deterministic probe in ``PROBE_RUNS`` fresh processes at once;
    returns their DETPROBE lines and seconds."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, PROBE], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(PROBE_RUNS)]
    lines = []
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        found = [line for line in out.splitlines() if line.startswith("DETPROBE ")]
        if proc.returncode != 0 or not found:
            nondet = [line for line in err.splitlines() if line.startswith("DETPROBE_NONDET")]
            raise AssertionError(f"phase 14 deterministic probe: exit {proc.returncode}; operations without a "
                                 f"deterministic implementation: {nondet or 'none named'}\n{err[-3000:]}")
        lines.append(found[0])
    return lines, time.perf_counter() - t0


def quality_msg(torch, mods, records, dev):
    """``PointNet2SAModuleMSG`` at SA0's shapes on the card against the
    same module on the plain kernels; returns the launch counts."""
    from patchaugnet_tpu_torch.models import PointNet2SAModuleMSG
    from patchaugnet_tpu_torch.nn import seeded_init_

    gen = torch.Generator(device=dev).manual_seed(80)
    xyz = torch.rand(B, N_POINTS, 3, generator=gen, device=dev)
    model = PointNet2SAModuleMSG(MSG_NPOINT, MSG_NSAMPLES, 3, (MSG_WIDTHS,) * len(MSG_NSAMPLES), radii=MSG_RADII,
                                 knn_dilation=MSG_DILATION)
    model = seeded_init_(model, torch.Generator().manual_seed(81)).to(dev).eval()
    with torch.no_grad():
        got, counts, _ = counted(torch, mods, records, lambda: model(xyz, xyz))
        check_launches(counts, MSG_LAUNCHES, "phase 14 PointNet2SAModuleMSG")
        with plain_kernels(mods):
            before = read_counts(mods, records)
            ref = model(xyz, xyz)
            plain_ms = time_ms(torch, lambda: model(xyz, xyz), 3)
            if read_counts(mods, records) != before:
                raise AssertionError("phase 14 PointNet2SAModuleMSG: the plain run launched a kernel")
        ms = time_ms(torch, lambda: model(xyz, xyz), 3)
    for name in ("new_xyz", "center_idx", "sample_idx"):
        check_equal(torch, f"phase 14 PointNet2SAModuleMSG {name}", getattr(got, name), getattr(ref, name))
    err = (got.features - ref.features).abs().max().item()
    if err > MSG_TOL or not torch.isfinite(got.features).all():
        raise AssertionError(f"phase 14 PointNet2SAModuleMSG: features max abs err {err} against the plain kernels")
    measured(f"phase 14 PointNet2SAModuleMSG, {B} x {N_POINTS} -> {MSG_NPOINT} centres, scales "
             f"{list(zip(MSG_NSAMPLES, MSG_RADII))}, dilation {MSG_DILATION}",
             f"{ms:.3f} ms per call ({plain_ms:.3f} on the plain kernels); indices equal, features max abs err "
             f"{err:.3g}, shape {tuple(got.features.shape)}; launches {counts}")
    return counts


def phase_quality(torch, mods, records, dev):
    """Phase 14: the recall-lift runs at full width, MinkLoc3Dv2's SmoothAP
    runs, the deterministic probe twice, and the multi-scale SA level
    against the plain kernels. Returns every counted run's launches."""
    t_phase = time.perf_counter()
    paths, trained = [], {}
    for family, precision in QUALITY_RUNS:
        result, counts = quality_family(torch, mods, records, dev, family, precision)
        paths.append(counts)
        trained[family, precision] = result["recall_at_1_trained"]
    f32, bf16 = trained["patch_aug_net", "float32"], trained["patch_aug_net", "bfloat16"]
    if bf16 < f32 - QUALITY_BF16_BAND:
        raise AssertionError(f"phase 14: the bf16-trained flagship's recall@1 {bf16:.2f} is more than "
                             f"{QUALITY_BF16_BAND} points below the f32 one's {f32:.2f}")
    say(f"phase 14: the bf16-trained flagship at {bf16:.2f} against f32 {f32:.2f} (band {QUALITY_BF16_BAND})")
    for backend in MINK_QUALITY_PARAMS:
        t0 = time.perf_counter()
        (r0, r1, losses, ms), counts, _ = counted(torch, mods, records, lambda: smoothap_quality(torch, dev, backend))
        check_launches(counts, {}, f"phase 14 minkloc3dv2 {backend} SmoothAP run")
        paths.append(counts)
        if r1 < MINK_QUALITY_MIN_RECALL or r1 < r0 + MINK_QUALITY_MIN_LIFT or not all(map(math.isfinite, losses)):
            raise AssertionError(f"phase 14 minkloc3dv2 {backend} SmoothAP: recall@1 {r0:.2f} -> {r1:.2f} (needs >= "
                                 f"{MINK_QUALITY_MIN_RECALL} and >= init + {MINK_QUALITY_MIN_LIFT}), losses {losses}")
        measured(f"phase 14 minkloc3dv2 {backend} SmoothAP, {MINK_QUALITY_STEPS} steps of {MINK_QUALITY_BATCH} "
                 f"clouds x {MINK_QUALITY_POINTS} points",
                 f"recall@1 {r0:.2f} -> {r1:.2f}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, {ms:.2f} ms per step "
                 f"(host clock), {time.perf_counter() - t0:.1f} s")
    lines, secs = quality_probe()
    recall = float(lines[0].split("recall=")[1].split()[0])
    recall16 = float(lines[0].split("recall_bf16=")[1].split()[0])
    if len(set(lines)) != 1 or recall < PROBE_RECALL_PIN or recall16 < recall - PROBE_BF16_BAND:
        raise AssertionError(f"phase 14 deterministic probe: lines {lines} (must be identical), recall {recall} "
                             f"(pin {PROBE_RECALL_PIN}), bf16 {recall16} (band {PROBE_BF16_BAND})")
    measured("phase 14 deterministic probe",
             f"{PROBE_RUNS} fresh processes print {lines[0]!r} alike (pin {PROBE_RECALL_PIN}); {secs:.1f} s")
    paths.append(quality_msg(torch, mods, records, dev))
    say(f"phase 14 (quality): {time.perf_counter() - t_phase:.1f} s")
    return paths


def main():
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from patchaugnet_tpu_torch import ops, serving
    from patchaugnet_tpu_torch.ops import cuda

    mods = {name: importlib.import_module(f"patchaugnet_tpu_torch.ops.{name}")
            for name in ("fps", "knn", "topk", "emd", "norm", "cuda")}
    smi = card_line()
    CARD = smi
    say(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    dev = serving.resolve_device("cuda")
    phase_build(cuda)
    records = phase_kernels(torch, ops, mods, dev) + phase_emd_kernels(torch, ops, mods, dev)
    serving_counts = phase_serving(torch, mods, records, dev)
    emd_counts, chunked_counts = phase_emd(torch, ops, mods, records, dev)
    center_counts, step_counts, step_ms, a2a_counts = phase_train(torch, mods, records, dev)
    cli_counts = phase_cli(torch, mods, records, step_ms)
    family_counts = phase_families(torch, ops, mods, records, dev)
    minkloc_counts = phase_minkloc(torch, mods, records, dev)
    deploy_counts = phase_deploy(torch, mods, records, dev)
    precision_counts = phase_precision(torch, mods, records, dev)
    parallel_counts = phase_parallel(torch, mods, records, dev)
    extras_counts = phase_extras(torch, ops, mods, records, dev)
    host_counts = phase_host(torch, mods, records, dev)
    quality_counts = phase_quality(torch, mods, records, dev)

    # each kernel's launches on its paths: K1-K3 serving, K6 emd_loss, K4
    # the row-chunked auction, K1 and K2 the train step and its centres,
    # the CLIs' epoch, eval and refresh, and PPT-Net's and PointNetVLAD's
    # serving, train steps and CLIs, MinkLoc3Dv2's (none), the
    # deployment's artifacts, in the fresh serving process and here, and
    # the bf16 forwards and steps and the REMAT step, the parallel layer's
    # runs, the extras of phase 12 and the host remainder's CLI batches,
    # nn_angle and traced forward, the quality runs and the multi-scale SA
    # level (each run counts only its own kernels)
    paths = (serving_counts, emd_counts, chunked_counts, center_counts, step_counts, a2a_counts, *cli_counts,
             *family_counts,
             *minkloc_counts, *deploy_counts, *precision_counts, *parallel_counts, *extras_counts, *host_counts,
             *quality_counts)
    launches = {name: sum(counts.get(name, 0) for counts in paths) for name in serving_counts}
    # K5 (``topk_extract_pair``) is K3's function by K3's kernel, on no path
    # (the JAX package dispatches it nowhere): its line repeats K3's times
    k3 = next(r for r in records if r.name == "topk_extract")
    k5 = KernelRecord("topk_extract_pair", "topk", k3.source, "patchaugnet_tpu/ops/pallas/knn.py:177")
    k5.cases, k5.max_abs_err = k3.cases, k3.max_abs_err
    launches[k5.name] = 0
    say(json.dumps({"kernels": [rec.as_json(launches[rec.name]) for rec in records + [k5]]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
