"""Traffic kind ``train``: a closed loop of tuple train steps.

Set-up makes the model with the benchmark's weights, its train state
(``train.create_train_state``) and step (``train.build_train_step``), and
a pool of ``pool`` tuple batches in pinned host memory: ``TRAIN_BATCH_SIZE``
tuples of (1 + positives + negatives + 1) scene clouds, the mask of the
queries and positives (the clouds of the patch branch), and a2b
correspondence tables of ``A2B_MAX_ROWS`` rows over the (query, positive)
pairs, patch slots drawn in [0, SAMPLING[0]), about ``a2b_valid_share``
of the rows valid and the last pair with none. A loader copies batch
j + 1 to the device on a second stream while step j runs.

The same state and step then take ``checked_steps`` steps on pool batches
0, 1, 2, ... through the loader: they are the warm-up, and the check's
readings (each step's metrics, the first gradient as Adam holds it
(``exp_avg / (1 - beta1)`` after step 1), the change of every parameter
and statistic after the last checked step). The window continues the
same state, reading each step's metrics one step late.

The check: once the window has closed and the program is freed, the
reference takes the same steps from the same weights on the same
batches. ``loss_gap``: the worst relative gap of the first step's
weighted loss terms (the later steps' gaps go to the record: Adam turns
round-off in gradients that vanish by symmetry into whole steps, so
their losses drift by up to 1e-3 in sound runs). ``grad_gap`` and
``change_gap``: the worst leaf's gap between the program's norm and the
reference's (of the first gradient; of the change after the checked
steps), over the larger of that leaf's reference norm and the median
leaf's. The change leaves out parameters whose reference gradient is
under ``grad_floor`` of the median leaf's, which move by round-off
alone; BatchNorm statistics are measured against the median statistic's
change.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import program, scene, tracing
from portbench.reference import tuple_step

BETA1 = 0.9
TINY_LOSS = 1e-6


def make_pool(r, cfg):
    """Clouds ``(P, B*T, N, 3)``, tables ``(P, 7, rows)`` int32 and the mask ``(B*T,)``."""
    t = r.traffic
    b, p = cfg["TRAIN_BATCH_SIZE"], cfg["TRAIN_POSITIVES_PER_QUERY"]
    tuple_len = 1 + p + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 1
    clouds = scene.scene_clouds(scene.rng_for(r.seed, 1), t["pool"] * b * tuple_len, t["points"])
    clouds = clouds.reshape(t["pool"], b * tuple_len, t["points"], 3)
    rng = scene.rng_for(r.seed, 3)
    mask = np.zeros(b * tuple_len, bool)
    for q in range(b):
        mask[q * tuple_len:q * tuple_len + 1 + p] = True
    rows, pairs = cfg["A2B_MAX_ROWS"], b * p
    tables = []
    for _ in range(t["pool"]):
        pair = rng.integers(0, pairs, rows)
        q_cloud = tuple_len * (pair // p)
        n_cloud = q_cloud + 1 + pair % p
        slots = [rng.integers(0, cfg["SAMPLING"][0], rows) for _ in range(3)]
        valid = (rng.random(rows) < t["a2b_valid_share"]) & (pair != pairs - 1)
        tables.append(np.stack([q_cloud, n_cloud, *slots, pair, valid]).astype(np.int32))
    return torch.from_numpy(clouds), torch.from_numpy(np.stack(tables)), torch.from_numpy(mask)


class Loader:
    """Batch j of the pool on the device; on the card batch j + 1 is copied
    on a second stream while step j runs (two buffers)."""

    def __init__(self, clouds, tables, mask, device):
        self.clouds, self.tables, self.device = clouds, tables, device
        self.mask = mask.to(device)
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.clouds, self.tables = clouds.pin_memory(), tables.pin_memory()
            self.stream = torch.cuda.Stream(device)
            self.buf = [(torch.empty(clouds.shape[1:], device=device), torch.empty(tables.shape[1:], dtype=torch.int32,
                                                                                   device=device)) for _ in range(2)]
            self.ready = [torch.cuda.Event(), torch.cuda.Event()]
            self.freed = [None, None]
            self._fetch(0)

    def _fetch(self, j: int) -> None:
        k, slot = j % 2, j % self.clouds.shape[0]
        with torch.cuda.stream(self.stream):
            if self.freed[k] is not None:
                self.stream.wait_event(self.freed[k])
            self.buf[k][0].copy_(self.clouds[slot], non_blocking=True)
            self.buf[k][1].copy_(self.tables[slot], non_blocking=True)
            self.ready[k].record(self.stream)

    def take(self, j: int):
        if not self.on_card:
            slot = j % self.clouds.shape[0]
            return self.clouds[slot], self.tables[slot], self.mask
        k = j % 2
        torch.cuda.current_stream(self.device).wait_event(self.ready[k])
        return self.buf[k][0], self.buf[k][1], self.mask

    def release(self, j: int) -> None:
        """Step j is queued: its buffer is free once it has run; fetch j + 1."""
        if self.on_card:
            self.freed[j % 2] = torch.cuda.Event()
            self.freed[j % 2].record(torch.cuda.current_stream(self.device))
            self._fetch(j + 1)


def correspondences(tables, num_pairs: int):
    from patchaugnet_tpu_torch.losses import PatchCorrespondences

    return PatchCorrespondences(*tables[:6], tables[6].bool(), num_pairs)


def _worst(values) -> float:
    """The largest value; infinite where any is not finite."""
    values = list(values)
    return float("inf") if any(not math.isfinite(v) for v in values) else max(values)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    if not names:
        return {}
    values = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names]).cpu().tolist()
    return dict(zip(names, values))


def run(r) -> None:
    from patchaugnet_tpu_torch import train

    cfg = program.model_config(r)
    dev = r.device
    phases = {"started": r.since_start()}
    model = program.build_model(r)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    state = train.create_train_state(model, cfg, device=dev)
    step_fn = train.build_train_step(model, cfg)
    clouds, tables, mask = make_pool(r, cfg)
    loader = Loader(clouds, tables, mask, dev)
    params = dict(model.named_parameters())
    phases["model and pool"] = r.since_start()
    num_pairs = cfg["A2B_MAX_PAIRS"]

    def do_step(j: int):
        nonlocal state
        c, tab, m = loader.take(j)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, c, correspondences(tab, num_pairs), m)
        enq = time.perf_counter() - t0
        loader.release(j)
        return metrics, enq

    checked: List[Dict[str, float]] = []
    first_grad: Dict[str, float] = {}
    for j in range(r.traffic["checked_steps"]):
        metrics, _ = do_step(j)
        checked.append({k: float(v) for k, v in metrics.items()})
        if j == 0:
            opt_state = state.optimizer.state
            first_grad = _norms({k: (opt_state[p]["exp_avg"] if "exp_avg" in opt_state.get(p, {})
                                     else torch.zeros_like(p)) / (1 - BETA1) for k, p in params.items()})
    now = model.state_dict()
    change = _norms({k: now[k] - initial[k] for k in initial})
    del initial, now
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()          # set-up's objects stay out of the collector's passes in the window
    r.values["setup_s"] = phases["checked steps"] = r.since_start()
    print("set-up, seconds since the process started:", phases, file=sys.stderr)

    backward = _backward_events(state) if r.trace else None
    keys = sorted(checked[0])
    host = [torch.empty(len(keys), pin_memory=dev.type == "cuda") for _ in range(2)]
    done = [None, None]
    enqueue_s, failed = [], [0]
    trace_at = r.seconds / 2 if r.trace else float("inf")
    traced, sliced, slice_s = 0, 0, 0.0

    def read(j: int) -> int:
        if done[j % 2] is not None:
            done[j % 2].synchronize()
        return int(not bool(torch.isfinite(host[j % 2]).all()))

    def one(j: int) -> None:
        metrics, enq = do_step(j)
        enqueue_s.append(enq)
        host[j % 2].copy_(torch.stack([metrics[k] for k in keys]), non_blocking=True)
        if dev.type == "cuda":
            done[j % 2] = torch.cuda.Event()
            done[j % 2].record()
        if j > first:
            failed[0] += read(j - 1)

    first = j = r.traffic["checked_steps"]
    t_window = time.perf_counter()
    while True:
        now_s = time.perf_counter() - t_window
        if now_s >= r.seconds and j > first:
            break
        if now_s >= trace_at and not traced:
            sliced = j - first
            traced, slice_s, r.card_trace, r.host_trace = tracing.profile_slices(r, one, j)
            j += traced
            continue
        one(j)
        j += 1
    failed[0] += read(j - 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t_window
    steps = j - first
    per_step = clouds.shape[1]
    r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    r.attempted, r.failed = steps, failed[0]
    r.values["train_clouds_per_s"] = steps * per_step / elapsed
    r.values["peak_mem_gib"] = r.memory_peak_bytes / 2**30
    r.record["items_per_s_untraced"] = (steps - traced) * per_step / (elapsed - slice_s)
    r.record["enqueue_s"] = enqueue_s[:sliced] + enqueue_s[sliced + traced:]
    if backward is not None:
        spans = backward()
        r.record["backward_device_s"] = spans[:sliced] + spans[sliced + traced:]

    del state, step_fn, model, params, loader
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(r, cfg, clouds, tables, mask, checked, first_grad, change)


def _backward_events(state):
    """CUDA events from the first gradient at one of the model's outputs to
    the optimizer's step pre-hook, every step; returns a reader of the
    seconds of each step."""
    from patchaugnet_tpu_torch.serving import global_desc

    marks: List[list] = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def first_grad(_grad):
        if marks and marks[-1][0] is None:
            marks[-1][0] = event()

    def outputs(_module, _args, out):
        marks.append([None, None])
        pd = getattr(out, "patch_data", None)
        for t in (global_desc(out),) + ((pd.patch_features, pd.reconstructed_patches) if pd else ()):
            if t is not None and t.requires_grad:
                t.register_hook(first_grad)

    def before_step(_opt, _args, _kwargs):
        if marks and marks[-1][0] is not None and marks[-1][1] is None:
            marks[-1][1] = event()

    state.model.register_forward_hook(outputs)
    state.optimizer.register_step_pre_hook(before_step)

    def read():
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in marks if a is not None and b is not None]

    return read


def check(r, cfg, clouds, tables, mask, checked, first_grad, change) -> None:
    ref = program.reference(r)
    dev = r.device
    params = program.reference_weights(r)
    initial = {k: v.clone() for k, v in params.items()}
    st = {"params": params, "m": {}, "v": {}, "t": 0}
    lr = cfg["BASE_LEARNING_RATE"]
    ref_losses, ref_grad = [], {}
    for j in range(len(checked)):
        slot = j % clouds.shape[0]
        batch = tuple_step.Batch(clouds[slot].to(dev), mask.to(dev), tuple(tables[slot].to(dev)),
                                 cfg["A2B_MAX_PAIRS"])
        metrics, grads = tuple_step.step(ref.forward, st, cfg, batch, lr)
        ref_losses.append(metrics)
        if j == 0:
            ref_grad = _norms(grads)
        del grads
    ref_change = _norms({k: params[k] - initial[k] for k in initial})
    limits = r.workload["limits"]

    by_step = [_worst(abs(p.get(k, math.nan) - q[k]) / max(abs(q[k]), TINY_LOSS) for k in q)
               for p, q in zip(checked, ref_losses)]
    loss_gap = by_step[0] if set(checked[0]) == set(ref_losses[0]) else float("inf")
    med_grad = statistics.median(ref_grad.values())
    grad_gap = _worst(abs(first_grad.get(k, 0.0) - g) / max(g, med_grad) for k, g in ref_grad.items())
    moved = [k for k, g in ref_grad.items() if g >= r.workload["check"]["grad_floor"] * med_grad]
    stats = [k for k in ref_change if tuple_step.is_stat(k)]
    gaps = {}
    for group in (moved, stats):
        med = statistics.median(ref_change[k] for k in group)
        gaps.update({k: abs(change.get(k, 0.0) - ref_change[k]) / max(ref_change[k], med) for k in group})
    r.record["excluded_leaves"] = sorted(set(ref_grad) - set(moved))
    r.record["loss_gap_by_step"] = by_step
    worst = max(gaps, key=lambda k: gaps[k] if math.isfinite(gaps[k]) else math.inf)
    print(f"loss gap by step {by_step}; worst change leaf {worst} {gaps[worst]!r}; "
          f"left out of the change: {r.record['excluded_leaves']}", file=sys.stderr)
    r.checks["loss_gap"] = (loss_gap, limits["loss_gap"])
    r.checks["grad_gap"] = (grad_gap, limits["grad_gap"])
    r.checks["change_gap"] = (_worst(gaps.values()), limits["change_gap"])
