"""The ``pan`` operator namespace: kernels K1, K2 and the fused eval
BatchNorm + ReLU as dispatcher operators.

``torch.ops.pan.fps``, ``torch.ops.pan.knn`` and ``torch.ops.pan.bn_relu``
are defined here with the low-level ``torch.library.Library`` API, and
each kernel's module (``ops/fps.py``, ``ops/knn.py``, ``ops/norm.py``)
registers its implementations into
:data:`LIB`: the kernel for ``"CUDA"``, the plain torch version for
``"CPU"``, and a fake one that gives the output shapes (``torch.export``
traces with tensors that hold no storage). An exported program therefore
holds one ``pan.fps`` / ``pan.knn`` / ``pan.bn_relu`` node per call on
either device, and launches the kernel on the card. No operator has an
autograd formula: no input of K1 or K2 needs a gradient on any path, and
``BatchNorm.relu`` calls ``pan.bn_relu`` only where no autograd is
recorded.

The launch shape (K1's threads and points per thread, K2's lanes per
query) is an argument: the Python wrappers pick it for the card they run
on, so an exported program keeps the shape of the card it was exported
on. The CPU implementations ignore it (the wrappers pass 0).

``torch.library.custom_op`` would define the same operators with more
host time per call; these launches are host-bound at the small levels
(PERF.md).
"""
from __future__ import annotations

import torch

LIB = torch.library.Library("pan", "DEF")
LIB.define("fps(Tensor xyz, int m, int threads, int ppt) -> Tensor")
LIB.define("knn(Tensor xyz, Tensor new_xyz, int k, int lanes) -> (Tensor, Tensor)")
LIB.define("bn_relu(Tensor x, Tensor mean, Tensor mul, Tensor bias) -> Tensor")
