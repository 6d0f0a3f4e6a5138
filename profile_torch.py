#!/usr/bin/env python3
"""Where the time of the port's PatchAugNet forward, or of its auction
EMD, goes on the card.

    python3 profile_torch.py [--batch 32] [--iters 5] [--table PATH]
    python3 profile_torch.py --emd [--table PATH]

Serves the full-width PatchAugNet (``configs.PATCH_AUG_NET``, seeded
random weights) through ``serving.build_forward_fn`` and reports, per
forward:

- each top-level stage (``sa0..sa2``, ``fp2..fp0``, ``aggregation``) in
  device time, bracketed by CUDA events from forward hooks;
- the host wall time and the device's busy share over the same window;
- the top operators and kernels by self device time from
  ``torch.profiler`` (``--table`` writes the full table to a file).

With ``--emd`` it runs ``ops.auction_emd`` instead, at the reference
call site of ``emd_loss`` (two (4, 4096, 3) clouds, eps 0.02, 1024
iterations): the host time of the exact call and of the opt-in
``unass_floor``/``eps_schedule`` modes, then one exact call under
``torch.profiler`` with the device's busy share, kernels per iteration,
K6's share and the top device kernels.

Every number is printed beside the card's name and power limit. Needs a
CUDA device; imports nothing of JAX.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 4096
STAGES = ("sa0", "sa1", "sa2", "fp2", "fp1", "fp0", "aggregation")
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


def profile_emd(torch, card, dev, table):
    from torch.profiler import ProfilerActivity, profile

    from patchaugnet_tpu_torch import ops
    from patchaugnet_tpu_torch.ops import emd

    gen = torch.Generator(device=dev).manual_seed(4)
    pc1 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    pc2 = torch.rand(EMD_B, EMD_N, 3, generator=gen, device=dev)
    ops.auction_emd(pc1, pc2, EMD_EPS, 8)                    # warm-up
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
    k6_ms = sum(getattr(r, key) for r in kernels if "topk_kernel<2, true>" in r.key) / 1e3
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--table", help="write the profiler's operator table to this file")
    parser.add_argument("--emd", action="store_true", help="profile the auction EMD instead")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from patchaugnet_tpu_torch import configs, serving
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import seeded_init_

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = serving.resolve_device("cuda")
    if args.emd:
        return profile_emd(torch, card, dev, args.table)
    model = seeded_init_(get_model("patch_aug_net", configs.PATCH_AUG_NET),
                         torch.Generator().manual_seed(0))
    forward = serving.build_forward_fn(model, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    clouds = torch.rand(args.batch, N_POINTS, 3, generator=gen, device=dev)
    for _ in range(2):
        forward(clouds)
    torch.cuda.synchronize()

    # stage times: CUDA events around each top-level submodule
    marks = {name: [] for name in STAGES}

    def pre(name):
        def hook(module, inputs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name].append([ev, None])
        return hook

    def post(name):
        def hook(module, inputs, output):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name][-1][1] = ev
        return hook

    handles = []
    for name in STAGES:
        sub = getattr(model, name)
        handles += [sub.register_forward_pre_hook(pre(name)), sub.register_forward_hook(post(name))]
    t0 = time.perf_counter()
    for _ in range(args.iters):
        forward(clouds)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    for h in handles:
        h.remove()
    stage_ms = {name: sum(a.elapsed_time(b) for a, b in marks[name]) / args.iters for name in STAGES}
    total = sum(stage_ms.values())
    print(f"[{card}] B={args.batch}: {wall_ms:.3f} ms per forward (host wall), "
          f"{args.batch / wall_ms * 1e3:.1f} descriptors/s", flush=True)
    for name in STAGES:
        print(f"[{card}] stage {name}: {stage_ms[name]:.3f} ms ({stage_ms[name] / total:.1%} of "
              f"{total:.3f} ms in stages)", flush=True)

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
          f"{window_ms / args.iters:.3f} ms window ({1 - device_ms / window_ms:.1%} idle)", flush=True)
    for r in sorted(timed, key=lambda r: -getattr(r, key))[:15]:
        print(f"[{card}]   {getattr(r, key) / 1e3 / args.iters:8.3f} ms  x{r.count // args.iters:<4d} "
              f"{r.key[:90]}", flush=True)
    if args.table:
        write_table(args.table, card, rows, key)
    return 0


if __name__ == "__main__":
    sys.exit(main())
