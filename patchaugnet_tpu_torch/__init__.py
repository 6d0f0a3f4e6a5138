"""PyTorch/CUDA port of the PatchAugNet place-recognition system.

Mirrors the layout of the JAX package ``patchaugnet_tpu`` (the
reference): ``ops`` (point ops, with hand-written CUDA kernels for the
hot paths under ``csrc/``), ``nn`` (building blocks), ``models``,
``losses`` (the reconstruction losses, auction EMD included), ``compat``
(weights carried over from the JAX package) and ``serving``.
Tensors are channels-last ``(B, N, C)`` at every public function, as in
the JAX package. This package never imports JAX or the JAX package.
"""
