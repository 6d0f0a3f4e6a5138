"""Descriptor serving: the eval forwards of the port's models.

Counterparts of ``build_forward_fn`` / ``build_local_forward_fn`` of
``patchaugnet_tpu/train/step.py``: a callable that takes a batch of
``(B, N, 3)`` f32 clouds and returns global descriptors ``(B, D)``, or
``(global, local, center_idx)`` with local = the second-to-last
feature-propagation level and centre indices = level-1 centres in the
input cloud, for the models that have them (PatchAugNet, PPT-Net; the
local forward of PointNetVLAD is ``None``). Each batch runs under
``torch.inference_mode()`` on the model's device, with the model in eval
mode whatever mode it was left in (a train step puts it in train mode),
and leaves that mode as it was: the JAX forwards pass ``train=False`` on
every call.

The export half of ``patchaugnet_tpu/serving.py``: :func:`export_descriptor_fn`
captures one of those forwards with ``torch.export`` at a fixed batch
size, :func:`save_artifact` writes the program with its weights and a
JSON sidecar, and :func:`load_artifact` serves it. A serving host needs
torch, the port's three registered kernels (``torch.ops.pan.fps``,
``torch.ops.pan.knn`` and ``torch.ops.pan.bn_relu``, ``ops/library.py``)
and the file: loading imports ``ops`` and none of ``models``, ``nn``,
``train`` or ``data``. The program holds one ``pan.fps`` / ``pan.knn`` /
``pan.bn_relu`` node per kernel launch, which runs the CUDA kernel on the
card and the plain version on the CPU.

Device note: the program's weights and the tensors it makes lie on the
device it was exported on, and the kernels' launch shapes are those
picked for that card (``ops/library.py``), so an artifact runs on the
device (and the card model) it was exported for; export on the serving
device. (The JAX package's artifact is bound to its lowering platforms
the same way, ``patchaugnet_tpu/serving.py:21-27``.)
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Clouds = Union[torch.Tensor, np.ndarray]
_META_SUFFIX = ".json"
_FORMAT = "patchaugnet-tpu-torch-serving/1"


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises ``RuntimeError`` when CUDA is asked for and absent.

    For CUDA it also switches TF32 and cuBLAS's bf16 reductions off
    (:func:`full_f32_products`).
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        full_f32_products()
    return device


def full_f32_products() -> None:
    """Switch TF32 off for matrix products and cuDNN: the port computes in
    full f32, as the JAX CLIs pin f32 matmul precision (low-precision
    products reorder near-tied retrieval rankings). Also switch off cuBLAS's
    reduced-precision reductions of bf16 products: a bf16 product
    (``COMPUTE_DTYPE``) accumulates in f32, as XLA's does. These are flags of
    the process, not of a model or an exported program."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _prepare(model: nn.Module, device) -> torch.device:
    device = resolve_device(device)
    model.to(device)
    return device


@contextlib.contextmanager
def _eval_mode(model: nn.Module) -> Iterator[None]:
    """Eval mode and no autograd for one call; the model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def global_desc(out) -> torch.Tensor:
    """The global descriptor of a model's output: the output itself where
    the model returns a bare tensor (PointNetVLAD), else its
    ``global_desc`` (the JAX step's ``_global_desc``)."""
    return out if isinstance(out, torch.Tensor) else out.global_desc


def has_local_fields(model: nn.Module) -> bool:
    """Whether ``model``'s output carries ``fp_features`` and
    ``center_idx_origin`` (PatchAugNet, PPT-Net)."""
    from .models import PatchAugNet, PPTNet

    return isinstance(model, (PatchAugNet, PPTNet))


def build_forward_fn(model: nn.Module, device: Union[str, torch.device] = "cuda") -> Callable:
    """``(B, N, 3) clouds -> (B, D)`` global descriptors on ``device``."""
    device = _prepare(model, device)

    def forward(clouds: Clouds) -> torch.Tensor:
        with _eval_mode(model):
            x = torch.as_tensor(clouds, dtype=torch.float32, device=device)
            return global_desc(model(x))

    return forward


def build_local_forward_fn(model: nn.Module, device: Union[str, torch.device] = "cuda") -> Optional[Callable]:
    """``(B, N, 3) clouds -> (global (B, D), local (B, K, C), center_idx (B, K))``,
    or ``None`` for a model without local descriptors (PointNetVLAD), as
    the JAX function returns."""
    if not has_local_fields(model):
        return None
    device = _prepare(model, device)

    def forward(clouds: Clouds) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with _eval_mode(model):
            x = torch.as_tensor(clouds, dtype=torch.float32, device=device)
            out = model(x)
            return out.global_desc, out.fp_features[-2], out.center_idx_origin[0]

    return forward


def platform_device(platform: str) -> torch.device:
    """The device of a CLI's ``--platform``: ``gpu`` (the card, the default
    of the CLIs) or ``cpu``. Exits with a message when the card is asked
    for and there is none: the CLIs never fall back to the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this command runs on an NVIDIA GPU; pass --platform cpu to run it on "
                         "the CPU")
    return resolve_device("cuda")


class _Descriptors(nn.Module):
    """The eval forward as a module: global descriptors, or the local
    forward's (global, local, centre indices)."""

    def __init__(self, model: nn.Module, with_local: bool):
        super().__init__()
        self.model, self.with_local = model, with_local

    def forward(self, clouds: torch.Tensor):
        out = self.model(clouds)
        if self.with_local:
            return out.global_desc, out.fp_features[-2], out.center_idx_origin[0]
        return global_desc(out)


def export_descriptor_fn(model: nn.Module, batch_size: int, n_points: int, *, with_local: bool = False,
                         device: Union[str, torch.device] = "cuda") -> torch.export.ExportedProgram:
    """Capture the eval forward of ``model`` on ``device`` (weights
    included) for ``(batch_size, n_points, 3)`` f32 clouds, the batch size
    baked in. ``with_local=True`` captures the (global, local, centre
    indices) forward, and raises for a model without local descriptors.
    The model runs in eval mode under ``torch.no_grad()`` while it is
    traced; its mode is restored."""
    if with_local and not has_local_fields(model):
        raise ValueError(f"{type(model).__name__} exposes no local descriptors; "
                         "export the global-only artifact instead")
    device = _prepare(model, device)
    example = torch.zeros((batch_size, n_points, 3), dtype=torch.float32, device=device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(_Descriptors(model, with_local), (example,))
    finally:
        model.train(was_training)


def _specs(program: torch.export.ExportedProgram) -> Tuple[List[Any], List[Any]]:
    """The values (fake tensors) of the program's user inputs and outputs."""
    sig = program.graph_signature
    inputs = [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder" and n.name in sig.user_inputs]
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    outputs = [n.meta["val"] for n in out_node.args[0] if n.name in sig.user_outputs]
    return inputs, outputs


def _describe(values) -> List[Dict[str, Any]]:
    return [{"shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")} for v in values]


def save_artifact(exported: torch.export.ExportedProgram, path: str, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the program (``torch.export.save``, weights included) to
    ``path`` and a JSON sidecar to ``<path>.json``: the format, the torch
    version, the device it was exported on, its inputs' and outputs'
    shapes and dtypes, its size in bytes, and ``meta``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    inputs, outputs = _specs(exported)
    device = inputs[0].device
    record = {
        "format": _FORMAT,
        "torch_version": torch.__version__,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "inputs": _describe(inputs),
        "outputs": _describe(outputs),
        "bytes": os.path.getsize(path),
    }
    record.update(meta or {})
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(record, f, indent=2)


def load_artifact(path: str) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact into a ``clouds -> outputs`` callable, with its
    sidecar's metadata (``{}`` where the sidecar is gone).

    The callable takes clouds of the exported shape only (a batch of
    another size raises ``ValueError``), on the device the artifact was
    exported on, and runs under ``torch.inference_mode()``; its
    ``program`` attribute is the loaded ``ExportedProgram``. Loading
    registers the port's kernels and switches TF32 and bf16 reductions off
    (:func:`full_f32_products`): the flags are not part of the program, and
    a fresh process would otherwise form the products in TF32, and reduce
    a bf16 artifact's products in bf16."""
    from . import ops  # noqa: F401  (registers the torch.ops.pan operators)

    full_f32_products()
    program = torch.export.load(path)
    inputs, _ = _specs(program)
    shape, device = tuple(inputs[0].shape), inputs[0].device
    module = program.module()

    def serve(clouds: Clouds):
        x = torch.as_tensor(clouds, dtype=torch.float32, device=device)
        if tuple(x.shape) != shape:
            raise ValueError(f"clouds of shape {tuple(x.shape)}: this artifact takes {shape} "
                             f"(its batch size is baked in)")
        with torch.inference_mode():
            return module(x)

    serve.program = program
    meta: Dict[str, Any] = {}
    if os.path.exists(path + _META_SUFFIX):
        with open(path + _META_SUFFIX) as f:
            meta = json.load(f)
    return serve, meta
