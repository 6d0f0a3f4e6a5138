#!/usr/bin/env python3
"""Where the time of the port's PatchAugNet forward, of its kernels, or of
its auction EMD, goes on the card.

    python3 profile_torch.py [--model M] [--batch 32] [--iters 5] [--table PATH] [--root DIR]
    python3 profile_torch.py --kernels [--model M] [--lanes] [--layouts] [--warps] [--batch 32] [--root DIR]
    python3 profile_torch.py --bn-relu [--model M] [--batch 32] [--root DIR]
    python3 profile_torch.py --emd [--table PATH] [--root DIR]
    python3 profile_torch.py --train [--model M] [--iters 5] [--table PATH] [--root DIR] [--remat]

Every form but ``--emd`` and ``--kernels`` takes ``--precision bfloat16``:
the model at that compute dtype (``COMPUTE_DTYPE``), on the same seeded
f32 weights. ``--remat`` (with ``--train``) recomputes the forward in the
backward (``REMAT``); the stages' forward hooks then fire in the
recomputation too, so each stage's time includes it.

``--model`` is ``patch_aug_net`` (the default), ``pptnet``,
``pptnet_l2_norm``, ``pointnet_vlad`` or ``minkloc3dv2``, each at the
full width of its config (``configs.PATCH_AUG_NET``, ``PPTNET_ORIGIN``,
``POINTNET_VLAD``, ``MINKLOC3DV2``). Serves the model (seeded random
weights) through ``serving.build_forward_fn`` and reports, per forward:

- each stage (PatchAugNet's ``sa0..sa2``, ``fp2..fp0``, ``aggregation``;
  PPT-Net's ``sa0..sa3``, ``fp3..fp0``, ``aggregation``; PointNetVLAD's
  ``point_net`` with its two STNs inside it, and ``net_vlad``;
  MinkLoc3Dv2's ``pyramid``, the tables and kernel maps, then in its
  ``backbone`` ``conv0``, each level's ``down{i}`` and ``block{i}_0``,
  the rest of the backbone being the top-down steps, and ``pooling``) in
  device time, bracketed by CUDA events from forward hooks;
- the host wall time, descriptors/s and the peak device memory, and the
  device's busy share and kernels per forward over the same window;
- the top operators and kernels by self device time from
  ``torch.profiler`` (``--table`` writes the full table to a file).

With ``--kernels`` it times each kernel at the shapes its path gives it
(with ``--model pptnet``, K1 and K2 at PPT-Net's four levels only),
``chip_smoke.py``'s cases with its bounds and yardsticks (K1 at the three
SA levels; K2 at the three SA levels at k=20 and the three FP levels'
3-NN at k=3; K3 on the FP levels' distance matrices, the 3-NN's former
route; K6 on the auction's full sweep and on its active-set tail read through
row ids, cold in L2 (eight id sets in turn) and warm (one set), beside
the old route, a gather and K6 on the gathered rows; K4 on a row-chunked
auction's chunk): the mean per call of back-to-back wrapper
calls (CUDA events, the wrapper's host cost included) beside the device
time per launch from the profiler's device rows, and their gap. Beside K1
it gives two floors: its dependent-step floor, a kernel that runs only
the pick each of K1's m - 1 steps needs (the warp and block arg-max and
the coordinates' hand-over) on K1's grid, and its per-SM update floor
(the update's instructions over one SM's instruction rate at the card's highest
SM clock). ``--lanes`` adds K2 at every lanes-per-query count the kernel
takes at that k, the data behind ``ops.knn.lanes_for``; ``--layouts``
adds K1's device time at every layout (threads per cloud, points per
thread) that holds each SA level, at B=32 and B=100, and clouds of 256,
512, 2048 and 8192 points at B=32, the data behind ``ops.fps.layout_for``;
``--warps`` adds the top-k kernel's device time at every warps-per-row
count it is built for, at the shapes of its paths (K6's tail and full
sweep, K4 at n=8192 and at n=16384, b=4, K3's FP0 matrix), the data
behind ``ops.topk.warps_for``. ``--root`` imports ``patchaugnet_tpu_torch`` from
another checkout with this package's interface (a commit unpacked with
``git archive``), so one call on one card can time both; a checkout
whose interface differs is timed with its own ``profile_torch.py``.

With ``--bn-relu`` it times the fused eval BatchNorm + ReLU
(``pan::bn_relu``) at each distinct ``(rows, C)`` that the model's eval
forward at ``--batch`` gives it (site 0 is the first SA level's first
layer): its mean per call of back-to-back calls and, from the profiler's
device rows, its device time per launch, its bytes bound (one read and
one write of f32, over 3.35 TB/s) and the share of that bound it reaches;
beside them the time per call and the device time of the four torch
passes it replaces (the subtraction, product and sum, then
``torch.relu``), whose result it must equal in every bit.

With ``--emd`` it runs ``ops.auction_emd`` instead, at the reference
call site of ``emd_loss`` (two (4, 4096, 3) clouds, eps 0.02, 1024
iterations): the host time of the exact call and of the opt-in
``unass_floor``/``eps_schedule`` modes, the number of active-set tail
iterations and the mean number of valid (non-padding) slots per tail
launch, then one exact call under ``torch.profiler`` with the device's
busy share, kernels per iteration, K6's share (every instantiation) and
the top device kernels.

With ``--train`` it runs the model's train step instead (PatchAugNet's
``configs.PATCH_AUG_NET_TRAIN`` with ``chip_smoke.py``'s batch of 72 clouds
of 4096 points and its correspondence tables; PPT-Net's tuple batch of 18
and PointNetVLAD's of 44 clouds, without tables; MinkLoc3Dv2's SmoothAP
step on ``chip_smoke.py``'s pair-expanded batch of 16): the host wall per
step of ``train.build_train_step`` (``train.build_smoothap_train_step``),
clouds/s and peak memory; the device ms of
the same step's parts from CUDA events that hooks record: the forward and
each of its stages and the patch decoder (module hooks), the losses (from
the forward's end to the first gradient that reaches one of the model's
outputs: the loss terms' forward and backward), the backward (to the
optimizer's step pre-hook, so the gradient fill and the loss gate of
``TrainState.apply_gradients`` count here) and the optimizer update; then
the step under ``torch.profiler`` with the device's busy share and the
top kernels.

Every number is printed beside the card's name and power limit. Needs a
CUDA device; imports nothing of JAX.
"""
import argparse
import importlib
import itertools
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402
from chip_smoke import time_ms  # noqa: E402
N_POINTS = 4096
# per model: its forward's config, its train step's, and its stages (a
# dotted name is a stage inside the one before it, not summed)
MODELS = {
    "patch_aug_net": ("PATCH_AUG_NET", "PATCH_AUG_NET_TRAIN",
                      ("sa0", "sa1", "sa2", "fp2", "fp1", "fp0", "aggregation")),
    "pptnet": ("PPTNET_ORIGIN", "PPTNET_ORIGIN",
               ("sa0", "sa1", "sa2", "sa3", "fp3", "fp2", "fp1", "fp0", "aggregation")),
    "pointnet_vlad": ("POINTNET_VLAD", "POINTNET_VLAD",
                      ("point_net", "point_net.stn", "point_net.feature_trans", "net_vlad")),
}
MODELS["pptnet_l2_norm"] = MODELS["pptnet"]
# MinkLoc3Dv2: the pyramid build (a method: sorts and searchsorted), then
# conv0, each level's down conv and block, the top-down steps (the
# backbone's rest), the pooling
MODELS["minkloc3dv2"] = ("MINKLOC3DV2", "MINKLOC3DV2", (
    "pyramid", "backbone", "backbone.conv0", "backbone.down0", "backbone.block0_0", "backbone.down1",
    "backbone.block1_0", "backbone.down2", "backbone.block2_0", "backbone.down3", "backbone.block3_0", "pooling"))
EMD_B, EMD_N, EMD_EPS, EMD_ITERS = 4, 4096, 0.02, 1024  # losses/pointnetvlad_loss.py:205-221


def device_kernels(prof):
    """(timing key, the profiler's device-kernel rows): kernels carry no
    CPU time, so summing them counts each kernel once."""
    rows = prof.key_averages()
    key = "self_device_time_total" if hasattr(rows[0], "self_device_time_total") else "self_cuda_time_total"
    return key, rows, [r for r in rows if getattr(r, key) > 0 and r.cpu_time_total == 0]


def write_table(path, card, rows, key):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{card}\n" + rows.table(sort_by=key, row_limit=60, max_name_column_width=100))


def device_ms(torch, fn, reps, match=None):
    """(device ms per launch, launches recorded per call) from the
    profiler's device rows over ``reps`` calls of ``fn``: the kernels whose
    name holds ``match``, or every kernel the call ran. Per launch is over
    the launches the profiler recorded, so a lost event shows as fewer
    launches per call, not as a shorter launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    key, _, kernels = device_kernels(prof)
    hits = [r for r in kernels if match is None or match in r.key]
    count = sum(r.count for r in hits)
    return sum(getattr(r, key) for r in hits) / 1e3 / max(count, 1), count / reps


K6_KERNEL = "topk_kernel<2, true"   # K6 at the auction's k=2, every instantiation (row ids or not, any S)
FPS_INSTRUCTIONS_PER_POINT = 12   # csrc/fps.cu's update: 3 sub, 3 mul, 2 add, a min; the arg-max's max, compare, select
SM_LANES_PER_CYCLE = 128          # four schedulers, one instruction for 32 lanes each a cycle


def sm_clock_mhz():
    """The card's highest SM clock, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def profile_kernels(torch, card, dev, batch, lanes_sweep, layouts_sweep, warps_sweep, model="patch_aug_net"):
    """K1-K4 and K6 at their paths' shapes: ``chip_smoke.py``'s cases, bounds
    and yardsticks, with the profiler's device time per launch beside each
    and the wrapper's host cost (per call minus device per call). For a
    PPT-Net, K1 and K2 at its four levels only (no other kernel is on its
    path)."""
    from patchaugnet_tpu_torch import ops
    from patchaugnet_tpu_torch.ops.cuda import _build as cuda

    knn = importlib.import_module("patchaugnet_tpu_torch.ops.knn")
    fps = importlib.import_module("patchaugnet_tpu_torch.ops.fps")

    def report(label, fn, match, b_ms, b_by, extra="", launches=1):
        """Per call: the median over 7 rounds of the mean of 50 back-to-back
        calls, so that a stall of the shared host falls out. ``launches``
        kernel launches per call: the device time per call is their device
        time per launch times that (the profiler may miss a launch's
        events; its count per call is printed beside)."""
        ms = statistics.median(time_ms(torch, fn, 50) for _ in range(7))
        dev_ms, per_call = device_ms(torch, fn, 20, match)
        print(f"[{card}] {label}: {ms:.4f} ms per call, device {dev_ms:.4f} ms per launch "
              f"({per_call:g} launches per call recorded), per call minus device "
              f"{ms - dev_ms * launches:.4f} ms, bound {b_ms:.4f} ms ({b_by}){extra}", flush=True)
        return dev_ms

    # a parent's package may predate the layouts (and its floor takes n)
    has_layouts = hasattr(fps, "layout_for")
    sms = cuda.sm_count(dev)
    clock = sm_clock_mhz()
    out = torch.empty(max(batch, 100), device=dev)

    def floor_ms(b, n, m, threads):
        args = (out, b, m, threads) if has_layouts else (out, b, n, m)
        return device_ms(torch, lambda: cuda.launch("fps", "pan_fps_step_floor", dev, *args), 20, "step_floor")[0]

    ppt = model.startswith("pptnet")
    levels = smoke.PPT_LEVELS if ppt else smoke.PATCH_LEVELS
    gen = torch.Generator(device=dev).manual_seed(0)
    x = smoke.level_clouds(torch, ops, ops.farthest_point_sample, gen, batch, levels)
    for lv in range(len(levels)):
        pts, m = x[lv], x[lv + 1].shape[1]
        n = pts.shape[1]
        layout = fps.layout_for(n) if has_layouts else None
        fps_ms = report(f"K1 fps SA{lv} (b,n,m)=({batch},{n},{m})" + (f", layout {layout}" if layout else ""),
                        lambda: ops.farthest_point_sample(pts, m), "fps_", *smoke.fps_bound(batch, n, m))
        if "pan_fps_step_floor" in cuda.LIBRARIES["fps"]:
            f_ms = floor_ms(batch, n, m, layout[0] if layout else 0)
            update_ms = n * FPS_INSTRUCTIONS_PER_POINT / SM_LANES_PER_CYCLE * (m - 1) / (clock * 1e3)
            print(f"[{card}] K1 fps SA{lv} floors: dependent steps (m - 1 = {m - 1} picks, timed alone) "
                  f"device {f_ms:.4f} ms, {f_ms / (m - 1) * 1e3:.4f} us per step, K1 {fps_ms / f_ms:.2f}x; "
                  f"per-SM update ({n} points x {FPS_INSTRUCTIONS_PER_POINT} instructions / "
                  f"{SM_LANES_PER_CYCLE} lanes per cycle x {m - 1} steps at {clock:g} MHz) {update_ms:.4f} ms",
                  flush=True)
    if layouts_sweep and has_layouts:
        # the SA levels at both batches, then clouds between and beyond them
        cases = []
        for b in (32, 100):
            xb = smoke.level_clouds(torch, ops, ops.farthest_point_sample, gen, b)
            cases += [(f"SA{lv}", xb[lv], xb[lv + 1].shape[1]) for lv in range(3)]
        cases += [(f"n={n}", torch.rand(32, n, 3, generator=gen, device=dev), n // 4) for n in (256, 512, 2048, 8192)]
        for label, pts, m in cases:
            b, n, _ = pts.shape
            rule = fps.layout_for(n)
            fits = [lay for lay in fps.LAYOUTS if lay[0] * lay[1] >= n or lay == fps.SCRATCH]
            for layout in fits:
                dev_ms = device_ms(torch, lambda: fps._fps_cuda(pts, m, layout=layout), 10, "fps_")[0]
                mark = " (the rule's)" if layout == rule else ""
                print(f"[{card}] K1 layout {label} (b,n,m)=({b},{n},{m}) (threads, points per thread) "
                      f"{layout}{mark}: device {dev_ms:.4f} ms", flush=True)
            for threads in sorted({t for t, _ in fits}):
                print(f"[{card}] K1 step floor {label} b={b} at {threads} threads: device "
                      f"{floor_ms(b, n, m, threads):.4f} ms", flush=True)
    for label, pts, qry, k in smoke.knn_cases(x):
        n, m = pts.shape[1], qry.shape[1]
        lib, form = smoke.knn_yardsticks(torch, ops, pts, qry, k)
        extra = f"; torch.topk on the distance matrix {lib:.4f} ms (+{form:.4f} ms to form it)"
        if label.startswith("FP"):
            old = lambda: smoke.matrix_knn(ops, pts, qry, k)   # noqa: E731
            old_dev, old_kernels = device_ms(torch, old, 20)
            extra += (f"; the matrix and K3 {time_ms(torch, old, 20):.4f} ms per call, device "
                      f"{old_dev * old_kernels:.4f} ms in {old_kernels:g} kernels")
        shape = f"(b,n,m,k)=({batch},{n},{m},{k}), {knn.lanes_for(batch, n, m, k, sms)} lanes"
        b_ms, b_by = smoke.knn_bound(batch, n, m, k)
        report(f"K2 knn {label} {shape}", lambda: ops.knn(pts, qry, k), "knn_kernel", b_ms, b_by, extra)
        if lanes_sweep:
            for g in knn.LANES:
                if -(-k // g) <= knn._MAX_SLOTS:
                    report(f"K2 knn {label} lanes={g}", lambda: knn._knn_cuda(pts, qry, k, lanes=g),
                           "knn_kernel", b_ms, b_by)
    if ppt:
        return 0
    for lv in range(3):
        dist = ops.pairwise_sqdist(x[lv], x[lv + 1])
        m, n = dist.shape[1], dist.shape[2]
        lib = time_ms(torch, lambda: torch.topk(dist, 3, dim=-1, largest=False), 10)
        report(f"K3 topk_extract FP{lv} (b,m,n,k)=({batch},{m},{n},3)", lambda: ops.topk_extract(dist, 3),
               "topk_kernel", *smoke.topk_bound(batch, m, n, 3), f"; torch.topk {lib:.4f} ms")
        del dist
    topk = importlib.import_module("patchaugnet_tpu_torch.ops.topk")
    gen = torch.Generator(device=dev).manual_seed(3)
    neg_base, price, id_sets = smoke.emd_sweep_inputs(torch, ops, gen)
    b, n = price.shape
    report(f"K6 topk_extract_price full sweep (b,m,n,k)=({b},{n},{n},2)",
           lambda: ops.topk_extract_price(neg_base, price, 2), K6_KERNEL, *smoke.price_bound(b, n, n))
    # the tail through the ids, and the old route (a gather, then K6 on the
    # gathered rows); cold (the id sets in turn) and warm (one set)
    routes = [("K6 through the ids", lambda ids: ops.topk_extract_price(neg_base, price, 2, ids)),
              ("gather, then K6", lambda ids: ops.topk_extract_price(smoke.gather_rows(torch, neg_base, ids),
                                                                     price, 2))]
    b_ms, b_by = smoke.tail_bound(n, id_sets[0])
    for label, fn in routes:
        for temp, sets in (("cold", id_sets), ("warm", id_sets[:1])):
            turn = iter(range(1 << 30))
            call = lambda: fn(sets[next(turn) % len(sets)])   # noqa: E731
            ms = statistics.median(time_ms(torch, call, 8 * len(id_sets)) for _ in range(7))
            queued = smoke.queued_ms(torch, lambda i: fn(sets[i % len(sets)]), 8 * len(id_sets))
            k6_ms, per_call = device_ms(torch, call, 24, K6_KERNEL)
            all_ms, kernels = device_ms(torch, call, 24)
            print(f"[{card}] K6 active-set tail (b,r,n,k)=({b},{sets[0].shape[1]},{n},2), {smoke.EMD_TAIL_VALID} "
                  f"valid slots, {temp} in L2, {label}: {ms:.4f} ms per call, device {queued:.4f} ms per call "
                  f"(queued behind a sleep kernel); profiler: K6 {k6_ms:.4f} ms per launch ({per_call:g} per "
                  f"call recorded), every kernel of the route {all_ms * kernels:.4f} ms in {kernels:g} kernels; "
                  f"per call minus device {ms - all_ms * kernels:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    chunk = smoke.chunked_input(torch, ops, gen)
    report(f"K4 topk_extract_chunked (b,m,n,k)=(1,4096,{smoke.CHUNKED_N},2)",
           lambda: ops.topk_extract_chunked(chunk, 2), "topk_kernel", *smoke.chunked_bound(chunk))
    report(f"K3 flat on K4's chunk (b,m,n,k)=(1,4096,{smoke.CHUNKED_N},2)",
           lambda: ops.topk_extract(chunk, 2), "topk_kernel", *smoke.chunked_bound(chunk))
    if warps_sweep:
        profile_warps(torch, card, dev, cuda, topk, neg_base, price, id_sets, chunk)
    return 0


def profile_warps(torch, card, dev, cuda, topk, neg_base, price, id_sets, chunk):
    """The top-k kernel's device ms per launch at every warps-per-row count
    it is built for, at the shapes of its paths, every input larger than
    the L2 cache: the tail takes its id sets in turn (a call's rows were
    last read about 105 MB of rows earlier)."""
    b, n = price.shape
    r = id_sets[0].shape[1]
    sms = cuda.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    full_sets = [torch.stack([torch.randperm(n, generator=gen, device=dev)[:r].sort().values for _ in range(b)])
                 for _ in id_sets]
    wide = torch.rand(4, 512, 16384, generator=gen, device=dev)
    fp0 = torch.rand(32, 4096, 1024, generator=gen, device=dev)
    turn = iter(range(1 << 30))
    cases = [
        ("K6 tail, padded ids", b * r, n,
         lambda s: topk._topk_extract_price_cuda(neg_base, price, 2, id_sets[next(turn) % len(id_sets)], warps=s)),
        ("K6 tail, every slot valid", b * r, n,
         lambda s: topk._topk_extract_price_cuda(neg_base, price, 2, full_sets[next(turn) % len(full_sets)],
                                                 warps=s)),
        ("K6 full sweep (4, 4096, 4096)", b * n, n,
         lambda s: topk._topk_extract_price_cuda(neg_base, price, 2, warps=s)),
        ("K4 (1, 4096, 8192)", chunk.shape[1], chunk.shape[2],
         lambda s: topk._topk_extract_cuda(chunk, 2, warps=s)),
        ("K4 at n=16384, b=4 (4, 512, 16384)", 4 * 512, 16384,
         lambda s: topk._topk_extract_cuda(wide, 2, warps=s)),
        ("K3 FP0 matrix (32, 4096, 1024), k=3", 32 * 4096, 1024,
         lambda s: topk._topk_extract_cuda(fp0, 3, warps=s)),
    ]
    for label, rows, cols, fn in cases:
        rule = topk.warps_for(rows, cols, sms)
        for s in topk.WARPS:
            dev_ms, per_call = device_ms(torch, lambda s=s: fn(s), 24, "topk_kernel")
            mark = " (the rule's)" if s == rule else ""
            print(f"[{card}] top-k warps {label}: {s} warps per row{mark}: device {dev_ms:.4f} ms "
                  f"({per_call:g} launches per call recorded)", flush=True)


def profile_emd(torch, card, dev, table):
    from torch.profiler import ProfilerActivity, profile

    from patchaugnet_tpu_torch import ops
    from patchaugnet_tpu_torch.ops import emd

    gen = torch.Generator(device=dev).manual_seed(4)
    pc1 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    pc2 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    ops.auction_emd(pc1, pc2, EMD_EPS, 8)                    # warm-up
    tail_launches, tail_slots = 0, []
    sweep = emd.topk_extract_price

    def spy(neg_base, price, k, rows=None):
        """Counts the tail's launches (rows read through ids) and the valid
        (non-padding) slots of each."""
        nonlocal tail_launches
        if rows is not None:
            tail_launches += 1
            tail_slots.append(int((rows < neg_base.shape[1]).sum()))
        return sweep(neg_base, price, k, rows)

    emd.topk_extract_price = spy
    try:
        ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS)
    finally:
        emd.topk_extract_price = sweep
    slots = (f"{statistics.mean(tail_slots):.1f} valid slots of {EMD_B} x 256 per tail launch on average"
             if tail_slots else "no tail launch")
    print(f"[{card}] auction_emd exact: {emd.iterations} iterations, {tail_launches} on the active-set tail, "
          f"{slots}", flush=True)
    call_ms = {}
    for label, kw in (("exact", {}), ("unass_floor=41", {"unass_floor": 41}),
                      ("eps_schedule=(10, 1)", {"eps_schedule": (10.0, 1.0)}),
                      ("unass_floor=41 + eps_schedule=(10, 1)",
                       {"unass_floor": 41, "eps_schedule": (10.0, 1.0)})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist, assignment = ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS, **kw)
        torch.cuda.synchronize()
        call_ms[label] = ms = (time.perf_counter() - t0) * 1e3
        unique = min(int(a.unique().numel()) for a in assignment)
        print(f"[{card}] auction_emd ({EMD_B},{EMD_N},3) eps={EMD_EPS}, {label}: {ms:.3f} ms, "
              f"{emd.iterations} iterations, {emd.unassigned} unassigned at exit, min unique "
              f"{unique}/{EMD_N}, mean sqdist {dist.mean().item():.6f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops.auction_emd(pc1, pc2, EMD_EPS, EMD_ITERS)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    key, rows, kernels = device_kernels(prof)
    device_ms = sum(getattr(r, key) for r in kernels) / 1e3
    k6_ms = sum(getattr(r, key) for r in kernels if K6_KERNEL in r.key) / 1e3
    exact = call_ms["exact"]
    print(f"[{card}] profiler, one exact call: device busy {device_ms:.3f} ms, "
          f"{sum(r.count for r in kernels) / emd.iterations:.1f} device kernels per iteration; "
          f"{1 - device_ms / exact:.1%} idle over the unprofiled {exact:.3f} ms call "
          f"({1 - device_ms / window_ms:.1%} over the {window_ms:.3f} ms profiled window); "
          f"K6 {k6_ms:.3f} ms = {k6_ms / exact:.1%} of the unprofiled call", flush=True)
    for r in sorted(kernels, key=lambda r: -getattr(r, key))[:10]:
        print(f"[{card}]   {getattr(r, key) / 1e3:8.3f} ms  x{r.count:<6d} {r.key[:90]}", flush=True)
    if table:
        write_table(table, card, rows, key)
    return 0




def hook_stages(model, stages, open_, close):
    """CUDA events around each stage of ``model``'s forward: forward hooks
    on each named submodule, and for ``pyramid`` a wrapper of MinkLoc's
    ``pyramid`` method. Returns handles with ``remove()``."""
    handles = []
    for name in stages:
        if name == "pyramid":
            inner = model.pyramid

            def timed(points, inner=inner):
                open_("pyramid")
                out = inner(points)
                close("pyramid")
                return out

            model.pyramid = timed
            handles.append(type("Unwrap", (), {"remove": staticmethod(lambda: delattr(model, "pyramid"))}))
            continue
        sub = model.get_submodule(name)
        handles.append(sub.register_forward_pre_hook(lambda m, a, name=name: open_(name)))
        handles.append(sub.register_forward_hook(lambda m, a, o, name=name: close(name)))
    return handles


def print_stages(card, stage_ms, what):
    """Each stage's device ms; a dotted stage is inside the one before its
    dot, and the rest of that one prints as ``<parent> rest``."""
    total = sum(ms for name, ms in stage_ms.items() if "." not in name)
    for name, ms in stage_ms.items():
        print(f"[{card}] {what} {name}: {ms:.3f} ms ({ms / total:.1%} of {total:.3f} ms in stages)", flush=True)
    for parent in [n for n in stage_ms if "." not in n and any(k.startswith(n + ".") for k in stage_ms)]:
        rest = stage_ms[parent] - sum(ms for k, ms in stage_ms.items() if k.startswith(parent + "."))
        print(f"[{card}] {what} {parent} rest: {rest:.3f} ms", flush=True)


def profile_train(torch, card, dev, iters, table, model_type="patch_aug_net", overrides=None):
    """The train step at full width: wall per step, its parts' device ms
    from CUDA events, and the profiler's busy share and top kernels.
    ``overrides`` go into the config (``COMPUTE_DTYPE``, ``REMAT``)."""
    from patchaugnet_tpu_torch import configs, serving, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_
    from torch.profiler import ProfilerActivity, profile

    _, cfg_name, stages = MODELS[model_type]
    cfg = dict(getattr(configs, cfg_name), model_type=model_type, **(overrides or {}))
    stages = stages + (("decoder",) if model_type == "patch_aug_net" else ())
    model = seeded_init_(get_model(model_type, cfg), torch.Generator().manual_seed(5))
    if model_type == "minkloc3dv2":         # the SmoothAP trainer on chip_smoke.py's pair-expanded batch
        schedule = train.multistep_schedule(cfg["BASE_LEARNING_RATE"], [250, 350], 1000)
        smoothap, tx = train.build_smoothap_train_step(model, schedule, weight_decay=cfg["WEIGHT_DECAY"],
                                                       tau1=cfg["tau1"], positives_per_query=cfg["positives_per_query"])
        state = train.create_train_state(model, cfg, device=dev, tx=tx)
        clouds, pos, neg = smoke.smoothap_batch(torch, dev, seed=6)
        step = lambda state: smoothap(state, clouds, pos, neg)
    else:
        state = train.create_train_state(model, cfg, device=dev)
        clouds, mask, corr = smoke.train_batch(torch, cfg, dev, seed=6)
        tuple_step = train.build_train_step(model, cfg)
        step = lambda state: tuple_step(state, clouds, corr, mask)
    for _ in range(2):
        state, _ = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[{card}] {model_type} train step {overrides or ''}, {clouds.shape[0]} clouds: {wall_ms:.3f} ms per step "
          f"(host wall), "
          f"{clouds.shape[0] / wall_ms * 1e3:.1f} clouds/s, peak memory {peak:.3f} GiB", flush=True)

    # the parts of the real step, bracketed by CUDA events from hooks: the
    # model's forward hooks, a gradient hook on each of its outputs (the
    # first to fire ends "loss", the loss terms' forward and backward), and
    # the optimizer's step hooks (its pre-hook ends "backward")
    marks = {name: [] for name in stages + ("forward", "loss", "backward", "optimizer")}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open_(name):
        marks[name].append([event(), None])

    def close(name, then=None):
        ev = event()
        marks[name][-1][1] = ev
        if then:
            marks[then].append([ev, None])

    def first_grad(grad):
        if marks["loss"][-1][1] is None:
            close("loss", then="backward")

    def outputs_hook(module, args, out):
        close("forward", then="loss")
        pd = getattr(out, "patch_data", None)
        outs = (serving.global_desc(out),) + ((pd.patch_features, pd.reconstructed_patches) if pd else ())
        for t in outs:
            if t is not None and t.requires_grad:
                t.register_hook(first_grad)

    model = state.model
    handles = [model.register_forward_pre_hook(lambda m, a: open_("forward")),
               model.register_forward_hook(outputs_hook),
               state.optimizer.register_step_pre_hook(lambda opt, a, k: close("backward", then="optimizer")),
               state.optimizer.register_step_post_hook(lambda opt, a, k: close("optimizer"))]
    handles += hook_stages(model, stages, open_, close)
    for _ in range(iters):
        state, _ = step(state)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    part = {name: sum(a.elapsed_time(b) for a, b in pairs) / iters for name, pairs in marks.items()}
    whole = part["forward"] + part["loss"] + part["backward"] + part["optimizer"]
    for name in ("forward", "loss", "backward", "optimizer"):
        print(f"[{card}] train {name}: {part[name]:.3f} ms ({part[name] / whole:.1%} of {whole:.3f} ms)",
              flush=True)
    print_stages(card, {name: part[name] for name in stages}, "  forward stage")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = step(state)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    key, rows, kernels = device_kernels(prof)
    busy = sum(getattr(r, key) for r in kernels) / 1e3
    print(f"[{card}] profiler: device busy {busy / iters:.3f} ms per step over a {window_ms / iters:.3f} ms "
          f"window ({1 - busy / window_ms:.1%} idle), {sum(r.count for r in kernels) / iters:.0f} kernels "
          f"per step", flush=True)
    for r in sorted(kernels, key=lambda r: -getattr(r, key))[:15]:
        print(f"[{card}]   {getattr(r, key) / 1e3 / iters:8.3f} ms  x{r.count // iters:<4d} {r.key[:90]}",
              flush=True)
    if table:
        write_table(table, card, rows, key)
    print(f"[{card}] metrics after step {state.step}: {({k: round(v.item(), 6) for k, v in metrics.items()})}")
    return 0


BN_RELU_BYTES_PER_ELEMENT = 8   # one f32 read, one written
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)


def profile_bn_relu(torch, card, dev, batch, model_type):
    """``pan::bn_relu`` at the (rows, C) of each eval BatchNorm -> ReLU site
    of ``model_type``'s forward at ``batch``, beside the four passes it
    replaces."""
    from patchaugnet_tpu_torch import configs, ops, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import core, seeded_init_

    cfg_name = MODELS[model_type][0]
    model = seeded_init_(get_model(model_type, getattr(configs, cfg_name)), torch.Generator().manual_seed(0))
    sites, order, real = {}, itertools.count(), core.bn_relu

    def spy(x, *vectors):
        sites.setdefault((x.numel() // x.shape[-1], x.shape[-1]), []).append(next(order))
        return real(x, *vectors)

    core.bn_relu = spy
    try:
        serving.build_forward_fn(model, device=dev)(torch.rand(batch, N_POINTS, 3, device=dev))
    finally:
        core.bn_relu = real
    gen = torch.Generator(device=dev).manual_seed(2)
    for (rows, c), where in sites.items():
        x = torch.randn(rows, c, generator=gen, device=dev)
        mean, bias = (torch.randn(c, generator=gen, device=dev) * 0.1 for _ in range(2))
        mul = torch.rand(c, generator=gen, device=dev) + 0.5
        fused = lambda: ops.bn_relu(x, mean, mul, bias)              # noqa: E731
        passes = lambda: torch.relu((x - mean) * mul + bias)        # noqa: E731
        same = torch.equal(fused().view(torch.int32), passes().view(torch.int32))
        ms = statistics.median(time_ms(torch, fused, 50) for _ in range(7))
        old_call = statistics.median(time_ms(torch, passes, 50) for _ in range(7))
        dev_ms, per_call = device_ms(torch, fused, 20, "bn_relu_kernel")
        old_ms, old_kernels = device_ms(torch, passes, 20)
        bound_ms = rows * c * BN_RELU_BYTES_PER_ELEMENT / PEAK_BYTES_PER_S * 1e3
        print(f"[{card}] pan::bn_relu {model_type} B={batch} sites {where} (rows, C)=({rows},{c}): {ms:.4f} ms "
              f"per call, device {dev_ms:.4f} ms per launch ({per_call:g} launches per call recorded), bytes bound "
              f"{bound_ms:.4f} ms, {bound_ms / dev_ms:.1%} of it; the four passes {old_call:.4f} ms per call, device "
              f"{old_ms * old_kernels:.4f} ms in {old_kernels:g} kernels; bit-equal {same}", flush=True)
        del x
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--table", help="write the profiler's operator table to this file")
    parser.add_argument("--emd", action="store_true", help="profile the auction EMD instead")
    parser.add_argument("--kernels", action="store_true",
                        help="time each kernel of the forward at its shapes instead")
    parser.add_argument("--lanes", action="store_true", help="with --kernels: K2 at every lanes count")
    parser.add_argument("--layouts", action="store_true",
                        help="with --kernels: K1 at every layout, at B=32 and B=100")
    parser.add_argument("--warps", action="store_true",
                        help="with --kernels: the top-k kernel at every warps-per-row count")
    parser.add_argument("--bn-relu", action="store_true",
                        help="time the fused eval BatchNorm + ReLU at the model's sites instead")
    parser.add_argument("--train", action="store_true", help="profile the train step instead")
    parser.add_argument("--model", default="patch_aug_net", choices=sorted(MODELS),
                        help="the model whose forward, kernels or train step to profile")
    parser.add_argument("--root", default=ROOT, help="checkout to import patchaugnet_tpu_torch from")
    parser.add_argument("--precision", default="float32", choices=["float32", "bfloat16"],
                        help="the model's compute dtype (COMPUTE_DTYPE) for the forward and --train")
    parser.add_argument("--remat", action="store_true", help="with --train: recompute the forward in the backward")
    args = parser.parse_args()
    overrides = {"COMPUTE_DTYPE": args.precision} if args.precision != "float32" else {}
    if args.remat:
        overrides["REMAT"] = True

    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = serving.resolve_device("cuda")
    print(f"[{card}] patchaugnet_tpu_torch from {os.path.dirname(serving.__file__)}", flush=True)
    if args.emd:
        return profile_emd(torch, card, dev, args.table)
    if args.kernels:
        return profile_kernels(torch, card, dev, args.batch, args.lanes, args.layouts, args.warps, args.model)
    if args.bn_relu:
        return profile_bn_relu(torch, card, dev, args.batch, args.model)
    if args.train:
        return profile_train(torch, card, dev, args.iters, args.table, args.model, overrides)
    cfg_name, _, stages = MODELS[args.model]
    model = seeded_init_(get_model(args.model, dict(getattr(configs, cfg_name), **overrides)),
                         torch.Generator().manual_seed(0))
    forward = serving.build_forward_fn(model, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    clouds = torch.rand(args.batch, N_POINTS, 3, generator=gen, device=dev)
    for _ in range(2):
        forward(clouds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        forward(clouds)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[{card}] {args.model} {args.precision} B={args.batch}: {wall_ms:.3f} ms per forward (host wall), "
          f"{args.batch / wall_ms * 1e3:.1f} descriptors/s, peak memory {peak:.3f} GiB", flush=True)

    # stage times: CUDA events around each stage
    marks = {name: [] for name in stages}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def open_(name):
        marks[name].append([event(), None])

    def close(name):
        marks[name][-1][1] = event()

    handles = hook_stages(model, stages, open_, close)
    for _ in range(args.iters):
        forward(clouds)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    print_stages(card, {name: sum(a.elapsed_time(b) for a, b in marks[name]) / args.iters for name in stages},
                 "stage")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            forward(clouds)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    key, rows, kernels = device_kernels(prof)
    timed = [r for r in rows if getattr(r, key) > 0]        # operators and kernels
    device_ms = sum(getattr(r, key) for r in kernels) / 1e3
    print(f"[{card}] profiler: device busy {device_ms / args.iters:.3f} ms per forward over a "
          f"{window_ms / args.iters:.3f} ms window ({1 - device_ms / window_ms:.1%} idle), "
          f"{sum(r.count for r in kernels) / args.iters:.0f} kernels per forward", flush=True)
    for r in sorted(timed, key=lambda r: -getattr(r, key))[:15]:
        print(f"[{card}]   {getattr(r, key) / 1e3 / args.iters:8.3f} ms  x{r.count // args.iters:<4d} "
              f"{r.key[:90]}", flush=True)
    if args.table:
        write_table(args.table, card, rows, key)
    return 0


if __name__ == "__main__":
    sys.exit(main())
