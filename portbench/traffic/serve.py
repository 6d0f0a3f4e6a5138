"""Traffic kind ``serve``: one closed-loop client embedding batches of clouds.

Set-up makes the model and its weights on the device, and a pool of
``pool`` distinct batches of ``batch`` scene clouds of ``points`` points
in pinned host memory, then runs ``warmup`` batches (the kernels load
and the allocator settles). The window sends batch after batch: copy
from the pool to the device, ``serving.build_forward_fn``'s forward, the
descriptors back to the host. A batch's time runs from its copy to its
descriptors on the host.

The traced run profiles ``trace_items`` batches card-only and then
``trace_host_items`` with the host from the middle of the window
(``tracing.profile_slices``); rates come from the untraced rest.

The check: once the window has closed and the program is freed, the
reference embeds a sample of the batches the window served (distinct
pool slots drawn from the seed) in blocks of clouds, and each served
descriptor is compared with the reference's: ``desc_gap`` is the worst
row's ``||served - reference|| / ||reference||``.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import program, scene, tracing
from portbench.reference.common import Net


def run(r) -> None:
    from patchaugnet_tpu_torch import serving

    t = r.traffic
    b, n, pool_size = t["batch"], t["points"], t["pool"]
    dev = r.device
    phases = {"started": r.since_start()}
    model = program.build_model(r)
    forward = serving.build_forward_fn(model, dev)
    phases["model"] = r.since_start()
    pool = torch.from_numpy(scene.scene_clouds(scene.rng_for(r.seed, 1), pool_size * b, n)).reshape(pool_size, b, n, 3)
    if dev.type == "cuda":
        pool = pool.pin_memory()
    staged = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    phases["pool"] = r.since_start()

    def serve(i):
        t0 = time.perf_counter()
        staged.copy_(pool[i % pool_size], non_blocking=True)
        t1 = time.perf_counter()
        out = forward(staged)
        t2 = time.perf_counter()
        host = out.to("cpu")
        return host, t2 - t1, time.perf_counter() - t0

    for i in range(t["warmup"]):
        serve(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()          # set-up's objects stay out of the collector's passes in the window
    r.values["setup_s"] = phases["warm-up"] = r.since_start()
    print("set-up, seconds since the process started:", phases, file=sys.stderr)

    outputs, batch_s, enqueue_s = [], [], []

    def one(i):
        host, enq, total = serve(i)
        outputs.append(host)
        batch_s.append(total)
        enqueue_s.append(enq)

    trace_at = r.seconds / 2 if r.trace else float("inf")
    traced, sliced, slice_s = 0, 0, 0.0
    first = i = t["warmup"]         # the window goes on through the pool where the warm-up stopped
    t_window = time.perf_counter()
    while True:
        now = time.perf_counter() - t_window
        if now >= r.seconds and i > first:
            break
        if now >= trace_at and not traced:
            sliced = i - first
            traced, slice_s, r.card_trace, r.host_trace = tracing.profile_slices(r, one, i)
            i += traced
            continue
        one(i)
        i += 1
    elapsed = time.perf_counter() - t_window
    r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    served = i - first
    r.attempted, r.failed = served * b, 0
    r.values["desc_per_s"] = served * b / elapsed
    r.values["peak_mem_gib"] = r.memory_peak_bytes / 2**30
    r.record["items_per_s_untraced"] = (served - traced) * b / (elapsed - slice_s)
    r.record["enqueue_s"] = enqueue_s[:sliced] + enqueue_s[sliced + traced:]
    r.record["batch_s"] = batch_s[:sliced] + batch_s[sliced + traced:]

    del forward, model, staged
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(r, pool, outputs, first)


def check(r, pool, outputs, first) -> None:
    """``desc_gap`` over a sample of the served batches (``outputs[k]`` is item ``first + k``)."""
    w = r.workload["check"]
    slots = sorted({(first + k) % len(pool): k for k in range(len(outputs))}.items())
    rng = np.random.default_rng([r.seed % 2**64, 2])
    picks = rng.choice(len(slots), size=min(w["sample_batches"], len(slots)), replace=False)
    ref = program.reference(r)
    cfg = program.model_config(r)
    net = Net(program.reference_weights(r))
    gaps = []
    with torch.no_grad():
        for p in sorted(picks):
            slot, k = slots[p]
            clouds = pool[slot]
            step = w["reference_block"]
            want = torch.cat([ref.forward(net, cfg, clouds[s:s + step].to(r.device)).cpu()
                              for s in range(0, clouds.shape[0], step)])
            got = outputs[k]
            gaps.append(torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1))
    r.checks["desc_gap"] = (float(torch.cat(gaps).max()), r.workload["limits"]["desc_gap"])
