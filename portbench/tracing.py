"""The profiled slices of a traced run and their reduction.

A traced run profiles two slices from the middle of its window
(:func:`profile_slices`). The first records the card alone (every kernel,
copy and set, and the CUDA calls that launched them), which costs the
host next to nothing, so its busy and idle shares are those of the
untraced window: it starts after a synchronise with a one-element fill on
the card and ends with another after a synchronise, and its span runs
from the first fill's start to the last one's end. The second, shorter,
records the host's operators with their shapes too, inside one host
range named :data:`SLICE` (its span): its host costs more, so it gives
the attribution of kernels to operators and labels the idle gaps, and
no share. :class:`Trace` reads either:

- the device is busy where any kernel, copy or set runs: the union of
  their intervals within the span (overlapping streams count once);
- the idle gaps are the span minus that union, each labelled with the
  innermost host range open at its midpoint on the slice's thread;
- an operator's kernels are the device operations whose launch (a CUDA
  runtime or driver call, matched through the profiler's correlation id)
  lies inside that operator's range on the same thread: attribution by
  launch, never by kernel name.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 100


@contextlib.contextmanager
def profiled(path: str, host: bool) -> Iterator[None]:
    """Profile the body and write the trace to ``path``: the card alone,
    bracketed by fills on the card, or with ``host`` the host's operators
    and their shapes too, inside the :data:`SLICE` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities, record_shapes=host) as prof:
        if host:
            with record_function(SLICE):
                yield
                torch.cuda.synchronize()
        else:
            marker.fill_(1.0)
            yield
            torch.cuda.synchronize()
            marker.fill_(2.0)
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def profile_slices(run, one, first: int):
    """Profile ``trace_items`` items (``one(i)`` serves item i) card-only,
    then ``trace_host_items`` with the host. Returns the items served, the
    seconds spent, and the two :class:`Trace` objects."""
    import tempfile

    folder = tempfile.mkdtemp(prefix="portbench-")
    traces, i, t0 = [], first, time.perf_counter()
    for host, key in ((False, "trace_items"), (True, "trace_host_items")):
        path = os.path.join(folder, f"{'host' if host else 'card'}.json")
        with profiled(path, host):
            for _ in range(run.workload[key]):
                one(i)
                i += 1
        traces.append(Trace(path))
        os.remove(path)
    os.rmdir(folder)
    return i - first, time.perf_counter() - t0, traces[0], traces[1]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """A profiled slice, read from its Chrome trace (times in microseconds)."""

    def __init__(self, path: str):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        slices = [e for e in events if e.get("name") == SLICE and e.get("cat") in ("user_annotation", "cpu_op")]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        if slices:
            s = slices[0]
            self.start, self.end, self.tid = float(s["ts"]), float(s["ts"]) + float(s["dur"]), s["tid"]
        elif self.device:
            self.start = min(float(e["ts"]) for e in self.device)
            self.end = max(float(e["ts"]) + float(e["dur"]) for e in self.device)
            self.tid = None
        else:
            raise ValueError(f"{path}: nothing ran on the card")
        clipped = [(max(float(e["ts"]), self.start), min(float(e["ts"]) + float(e["dur"]), self.end))
                   for e in self.device]
        self.busy = _union([(a, b) for a, b in clipped if b > a])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def device_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations (by name) that took most time, in seconds."""
        total: Dict[str, float] = defaultdict(float)
        for e in self.device:
            total[e["name"][:NAME_CHARS]] += float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.start] + [x for ab in self.busy for x in ab] + [self.end]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds summed by the host range open at each gap's midpoint
        (the innermost on the slice's thread), the ``n`` largest."""
        gaps = self.gaps()
        host = sorted((e for e in self.host if e["tid"] == self.tid and e.get("name") != SLICE),
                      key=lambda e: (float(e["ts"]), -float(e["dur"])))
        total: Dict[str, float] = defaultdict(float)
        stack: List[dict] = []
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and float(host[i]["ts"]) <= mid:
                ev = host[i]
                while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) <= float(ev["ts"]):
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) <= mid:
                stack.pop()
            label = stack[-1]["name"][:NAME_CHARS] if stack else "python between operators"
            total[label] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def op_calls(self, names: Sequence[str]) -> List[dict]:
        """Each call of an operator in ``names`` with its input shapes, its
        scalar arguments and the device seconds of the operations it launched."""
        by_corr: Dict[int, float] = defaultdict(float)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] += float(e["dur"]) / 1e6
        launches: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
        for e in self.host:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launches[e["tid"]].append((float(e["ts"]), corr))
        for v in launches.values():
            v.sort()
        calls = []
        for e in self.host:
            if e.get("cat") != "cpu_op" or e["name"] not in names:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            rows = launches.get(e["tid"], [])
            lo, hi = bisect.bisect_left(rows, (a, -1)), bisect.bisect_right(rows, (b, float("inf")))
            args = e.get("args", {})
            calls.append({"name": e["name"], "dims": args.get("Input Dims"), "scalars": args.get("Concrete Inputs"),
                          "launches": hi - lo, "device_s": sum(by_corr.get(c, 0.0) for _, c in rows[lo:hi])})
        return calls


def scalar(call: dict, i: int) -> Optional[int]:
    """The ``i``-th argument of a recorded call as an integer, if recorded."""
    vals = call.get("scalars") or []
    try:
        return int(vals[i])
    except (IndexError, TypeError, ValueError):
        return None
