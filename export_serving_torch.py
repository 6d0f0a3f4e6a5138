#!/usr/bin/env python
"""Export a model of the PyTorch/CUDA port as a self-contained serving artifact.

The port's counterpart of ``export_serving.py``. It loads weights as
``evaluate_torch.py`` does (a reference ``.pth`` through
``compat.load_torch_checkpoint``, or a checkpoint of ``train_torch.py``;
without ``--weight`` the seeded initialisation), captures the eval forward
with ``torch.export`` at each batch size (``serving.export_descriptor_fn``),
and writes one artifact per batch size and flavour, each with a JSON
sidecar. A serving host then needs torch, the port's three registered
kernels and the file:

    fwd, meta = patchaugnet_tpu_torch.serving.load_artifact("patch_aug_net_desc_b32.pt2")
    descs = fwd(clouds)          # (32, 4096, 3) f32 -> (32, 256) f32

It runs on the card (``--platform gpu``, the default; without a CUDA
device it exits with a message), or on the CPU with ``--platform cpu``.
An artifact runs on the device it was exported on: export on the serving
card. ``--precision bfloat16`` exports the forward at that compute dtype
(``COMPUTE_DTYPE``; f32 weights, f32 descriptors), and the sidecar's
``precision`` says so.

Usage:
  python export_serving_torch.py --model_type patch_aug_net \\
      --weight ref_train_epoch_29_end.pth --out exp/serving --batch_sizes 32 100 [--with_local] \
      [--precision bfloat16]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from evaluate_torch import CONFIG_TABLE


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Serving artifact export (PyTorch/CUDA port)")
    p.add_argument("--model_type", type=str, default="patch_aug_net", choices=sorted(CONFIG_TABLE))
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--weight", type=str, default=None,
                   help="reference .pth or checkpoint of train_torch.py (omit for a randomly initialised model)")
    p.add_argument("--out", type=str, default="exp/serving", help="output directory")
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[32])
    p.add_argument("--n_points", type=int, default=None, help="override the config NUM_POINTS")
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of the forward (COMPUTE_DTYPE)")
    p.add_argument("--with_local", action="store_true",
                   help="also export the (global, local, centre indices) artifact for the rerank store")
    p.add_argument("--platform", type=str, default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default: the CUDA card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Export as ``export_serving.py`` does; returns the artifacts' paths."""
    args = get_args(argv)
    from patchaugnet_tpu_torch.serving import platform_device

    device = platform_device(args.platform)

    from patchaugnet_tpu_torch import serving
    from patchaugnet_tpu_torch.configs import load_config

    from evaluate_torch import load_state, set_precision

    cfg = load_config(args.config or CONFIG_TABLE[args.model_type])
    cfg["model_type"] = args.model_type
    set_precision(cfg, args.precision)
    model = load_state(args.model_type, cfg, args.weight, device).model
    if not args.weight:
        print("no --weight: exporting a randomly initialised model")
    n_points = args.n_points or cfg["NUM_POINTS"]
    meta = {"model_type": args.model_type, "weight": args.weight, "precision": args.precision, "n_points": n_points}
    flavours = [("desc", False)] + ([("local", True)] if args.with_local else [])
    paths = []
    for b in args.batch_sizes:
        for tag, with_local in flavours:
            t0 = time.perf_counter()
            exported = serving.export_descriptor_fn(model, b, n_points, with_local=with_local, device=device)
            seconds = time.perf_counter() - t0
            path = os.path.join(args.out, f"{args.model_type}_{tag}_b{b}.pt2")
            serving.save_artifact(exported, path,
                                  {**meta, "batch_size": b, "flavour": tag, "export_seconds": seconds})
            print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB, {device}, exported in {seconds:.1f} s)")
            paths.append(path)
    return paths


if __name__ == "__main__":
    main()
