"""Logging and metrics.

Port of ``patchaugnet_tpu/utils/logging_util.py``: python logging to the
console and to ``train.log`` under a timestamped event directory (the
reference's ``train_place_recognition.py:57-70``), and scalar metrics to
``metrics.jsonl`` there, always, and to TensorBoard when it imports
(:399, 414, 485-487).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def get_logger(log_dir: Optional[str] = None, name: str = "patchaugnet_tpu_torch") -> logging.Logger:
    """The named logger, built once per process: console, and ``train.log``
    in ``log_dir`` when one is given the first time. A handler that a
    caller attached before the first call (a test's capture) does not stop
    the build, so INFO records reach it."""
    logger = logging.getLogger(name)
    if getattr(logger, "_built_by_get_logger", False):
        return logger
    logger._built_by_get_logger = True
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsWriter:
    """Scalar metrics to JSONL (and TensorBoard if it imports)."""

    def __init__(self, event_dir: str):
        os.makedirs(event_dir, exist_ok=True)
        self._f = open(os.path.join(event_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:                     # the tensorboard package is optional
            return
        self._tb = SummaryWriter(event_dir)

    def add_scalars(self, tag: str, scalars: Dict[str, float], step: int) -> None:
        rec = {"tag": tag, "step": step, "ts": time.time(), **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, scalars, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
