"""Model FLOPs, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` over the reference counts its
matrix products (two FLOPs per multiply-add; elementwise work, sorts and
gathers count nothing): the model's products, whatever implementation
runs them. Products are per row, so the count is linear in the batch:
the forward is counted on one cloud, the train step on one tuple (its
forward, the patch branch on that tuple's queries and positives, and the
backward), and ``workloads/<cell>.json`` stores the count per item
(``tools/count_flops.py`` prints it).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import tuple_step
from .reference.common import Net
from .scene import rng_for, scene_clouds
from .weights import make_weights


def forward_flops(ref, cfg: Dict[str, Any], points: int) -> float:
    """FLOPs of the reference's eval forward on one cloud."""
    net = Net(make_weights(ref.spec(cfg), 0, "cpu"))
    x = torch.from_numpy(scene_clouds(rng_for(0, 0), 1, points))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(net, cfg, x)
    return float(counter.get_total_flops())


def train_flops_per_cloud(ref, cfg: Dict[str, Any], points: int) -> float:
    """FLOPs of one reference train step on one tuple, per cloud."""
    cfg = dict(cfg, TRAIN_BATCH_SIZE=1)
    p = cfg["TRAIN_POSITIVES_PER_QUERY"]
    tuple_len = 1 + p + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 1
    clouds = torch.from_numpy(scene_clouds(rng_for(0, 0), tuple_len, points))
    mask = torch.zeros(tuple_len, dtype=torch.bool)
    mask[:1 + p] = True
    zeros = torch.zeros(cfg["A2B_MAX_ROWS"], dtype=torch.int32)
    corr = (zeros, zeros + 1, zeros, zeros, zeros, zeros, zeros + 1)
    batch = tuple_step.Batch(clouds, mask, corr, cfg["A2B_MAX_PAIRS"])
    state = {"params": make_weights(ref.spec(cfg), 0, "cpu"), "m": {}, "v": {}, "t": 0}
    counter = FlopCounterMode(display=False)
    with counter:
        tuple_step.step(ref.forward, state, cfg, batch, cfg["BASE_LEARNING_RATE"])
    return float(counter.get_total_flops()) / tuple_len
