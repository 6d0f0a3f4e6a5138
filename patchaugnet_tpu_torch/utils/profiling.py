"""Parameter counts, FLOPs, device timing and trace capture.

The port's counterpart of ``patchaugnet_tpu/utils/profiling.py``, which
stands in for the reference's fvcore ``FlopCountAnalysis`` and
``parameter_count_table`` (utils/train_util.py:210-220, called at
train_place_recognition.py:549-553) and its cuda-synchronised timing
(scene_dataset.py:531-539); :func:`trace` takes the place of the JAX
package's ``jax.profiler`` capture.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch
from torch import nn


def flops(fn: Callable, *example_args, **example_kwargs) -> float:
    """FLOPs of one call of ``fn``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` while the call runs.

    It counts what PyTorch's FLOP formulas cover: matrix products
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``einsum``'s products),
    convolutions and attention, two FLOPs per multiply-add. Elementwise
    ops, reductions, gathers and the port's kernels (FPS, kNN, top-k) count
    nothing, where XLA's cost analysis (the JAX package's ``flops``) counts
    every op, so the two totals differ. Run it under ``torch.no_grad()``
    for a forward alone."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args, **example_kwargs)
    return float(counter.get_total_flops())


def parameter_count(model: nn.Module) -> Dict[str, int]:
    """Parameters per top-level module of ``model`` and their ``TOTAL``
    (the fvcore ``parameter_count_table`` analogue)."""
    out: Dict[str, int] = {}
    for name, module in model.named_children():
        out[name] = sum(p.numel() for p in module.parameters())
    own = sum(p.numel() for p in model.parameters(recurse=False))
    if own:
        out["(own)"] = own
    out["TOTAL"] = sum(p.numel() for p in model.parameters())
    return out


class DeviceTimer:
    """Times calls on ``device``: CUDA events around the work on the card
    (each read after its end event has completed), the host's wall clock
    on the CPU."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device("cpu" if device is None else device)
        self.times_ms: List[float] = []

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            self.times_ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            yield
            self.times_ms.append((time.perf_counter() - t0) * 1000)

    def timed_call(self, fn: Callable, *args):
        with self.measure():
            out = fn(*args)
        return out

    def stats(self, skip_first: bool = True) -> Dict[str, float]:
        t = np.array(self.times_ms[1:] if skip_first and len(self.times_ms) > 1 else self.times_ms)
        return {"mean_ms": float(t.mean()), "std_ms": float(t.std()), "n": len(t)}


@contextlib.contextmanager
def trace(log_dir: str, device: Union[str, torch.device] = "cuda") -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the body: the host's operators (the kernels'
    dispatcher calls ``pan::fps`` and ``pan::knn`` among them) and, on a
    CUDA ``device``, every kernel the card ran (synchronised at the end).
    Yields the profiler; on exit writes a Chrome trace (view it in
    ``chrome://tracing`` or Perfetto) to ``log_dir/trace-<pid>-<ns>.json``,
    whose path the profiler keeps as ``trace_path``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize(device)
    prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
