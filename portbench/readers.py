"""The arithmetic of the per-layer metrics; each ``metrics/<name>.py``
calls one of these on its run. A reader with nothing to read returns
None, and the metric is left out of the line."""
from __future__ import annotations

import statistics
from typing import Optional

import numpy as np

from . import tracing, yardstick

KERNEL_OPS = ("pan::fps", "pan::knn")


def mean_ms(run, key: str) -> Optional[float]:
    values = run.record.get(key)
    return statistics.fmean(values) * 1e3 if values else None


def p95_ms(run, key: str) -> Optional[float]:
    values = run.record.get(key)
    return float(np.percentile(np.asarray(values) * 1e3, 95)) if values else None


def mfu_pct(run) -> Optional[float]:
    """Model FLOPs per item (counted on the reference, ``workloads/<cell>.json``)
    times the items per second of the untraced window, over the peak of the
    configuration's dtype."""
    rate = run.record.get("items_per_s_untraced")
    if not rate:
        return None
    return run.workload["model_flops_per_item"] * rate / yardstick.PEAKS[run.config["dtype"]] * 100


def idle_pct(run) -> Optional[float]:
    """The card-only slice's span covered by no kernel, copy or set."""
    t = run.card_trace
    if t is None or t.window_s <= 0:
        return None
    return (1 - t.busy_s / t.window_s) * 100


def fps_knn_roofline_pct(run) -> Optional[float]:
    """The least time of every K1 and K2 call in the host-profiled slice
    (from its recorded shapes) over the device time of what those calls
    launched."""
    t = run.host_trace
    if t is None:
        return None
    least = spent = 0.0
    for call in t.op_calls(KERNEL_OPS):
        dims = call["dims"] or []
        if call["name"] == "pan::fps":
            m = tracing.scalar(call, 1)
            if m is None or not dims or len(dims[0]) != 3:
                return None
            b, n, _ = dims[0]
            least += yardstick.fps_bound_s(b, n, m)
        else:
            k = tracing.scalar(call, 2)
            if k is None or len(dims) < 2 or len(dims[1]) != 3:
                return None
            b, n, _ = dims[0]
            least += yardstick.knn_bound_s(b, n, dims[1][1], k)
        spent += call["device_s"]
    return least / spent * 100 if spent > 0 else None
