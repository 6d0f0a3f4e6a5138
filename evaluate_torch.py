#!/usr/bin/env python
"""Evaluation CLI of the PyTorch/CUDA port (``patchaugnet_tpu_torch``).

The port's counterpart of ``evaluate.py``, with its flags and its
``CONFIG_TABLE``: model_type -> config resolution, checkpoint load, then
whole-database descriptor extraction (timed), per-trip-pair
recall/precision, and the top-k feature-space dump (top_k=300), which
runs by default. ``--weight`` is a reference ``.pth`` (read by
``compat.load_torch_checkpoint``, as ``evaluate.py:124-136`` reads it)
or a checkpoint of ``train_torch.py``. It runs on the card; ``--platform
cpu`` runs it on the CPU, and without a CUDA device and without that flag
it exits with a message.

It evaluates ``patch_aug_net``, ``pptnet``, ``pptnet_l2_norm``,
``pointnet_vlad`` and ``minkloc3dv2``; a model without local descriptors
(PointNetVLAD, MinkLoc3Dv2) takes the global forward where the
descriptor store would take the local one. ``--precision bfloat16`` runs
the forward at that compute dtype (``COMPUTE_DTYPE``) on the same f32
weights. ``--devices N`` shards the records of each batch over N ranks, one
process each (``parallel.build_parallel_local_forward``, as
``evaluate.py:147-165``; ``--batch_size`` must split evenly): every rank
gets the whole batch's outputs back, and rank 0 alone logs and writes the
descriptor store and the top-k dump, the bytes of a ``--devices 1`` run.
The ranks use NCCL on cards of their own, gloo with ``--platform cpu``, and
gloo on one card with ``--share-device``. The JAX package's orbax
checkpoint directories are refused for good (ROADMAP C): the card's
machine has neither JAX nor orbax, and ``compat.load_jax_variables``
carries JAX weights as numpy.

Usage:
  python evaluate_torch.py --model_type patch_aug_net \
      --weight exp/patch_aug_net/saved_model/train_epoch_29_end --dataset oxford
  python evaluate_torch.py --model_type patch_aug_net --weight ref_train_epoch_29_end.pth --dataset oxford
  python evaluate_torch.py --model_type patch_aug_net --dataset synthetic   # random init smoke
  python evaluate_torch.py --model_type pointnet_vlad --dataset synthetic
  python evaluate_torch.py --model_type minkloc3dv2 --dataset synthetic
  python evaluate_torch.py --model_type patch_aug_net --dataset synthetic --precision bfloat16
  python evaluate_torch.py --config configs/tiny_smoke.yaml --dataset synthetic --platform cpu --devices 2
"""
import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CONFIG_TABLE = {
    "patch_aug_net": "configs/patch_aug_net.yaml",
    "pptnet": "configs/pptnet_origin.yaml",
    "pptnet_l2_norm": "configs/pptnet_origin.yaml",
    "pointnet_vlad": "configs/pointnet_vlad.yaml",
    "minkloc3dv2": "configs/minkloc3dv2.yaml",
}


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Place Recognition Evaluation (PyTorch/CUDA port)")
    p.add_argument("--model_type", type=str, default="patch_aug_net",
                   choices=sorted(CONFIG_TABLE))
    p.add_argument("--config", type=str, default=None,
                   help="override the model_type -> config resolution")
    p.add_argument("--weight", type=str, default=None,
                   help="reference .pth or checkpoint of train_torch.py")
    p.add_argument("--dataset", type=str, default="oxford")
    p.add_argument("--exp_dir", type=str, default="exp")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--top_k", type=int, default=300, help="feature-space dump size")
    # the reference always runs the top-k dump before recall
    # (evaluate.py:171); opt out rather than in
    p.add_argument("--no_save_top_k", action="store_true",
                   help="skip the top-k rerank dump before recall")
    p.add_argument("--top_k_space", type=str, default="feat",
                   choices=["feat", "euc"], help="top-k dump space")
    p.add_argument("--no_save_descs", action="store_true",
                   help="skip the per-record global/local descriptor store")
    p.add_argument("--platform", type=str, default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default: the CUDA card) or cpu")
    p.add_argument("--devices", type=int, default=1,
                   help="devices for descriptor extraction: one rank per device")
    p.add_argument("--share-device", action="store_true",
                   help="with --devices above the card count, put the ranks on the cards in turn (over gloo)")
    p.add_argument("--precision", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the forward (COMPUTE_DTYPE); checkpoints are precision-agnostic")
    return p.parse_args(argv)


def refuse_unported(args):
    """Raise for what the port does not take: an orbax directory
    (``NotImplementedError``), a batch that does not split over
    ``--devices`` (``ValueError``)."""
    if args.batch_size % args.devices:
        raise ValueError(f"--batch_size {args.batch_size} must split evenly over --devices {args.devices}")
    if args.weight and os.path.isdir(args.weight):
        raise NotImplementedError(
            f"--weight {args.weight}: orbax checkpoint directories of the JAX package are not read (ROADMAP C): "
            f"the card's machine has neither JAX nor orbax; carry JAX weights as numpy with "
            f"compat.load_jax_variables, or pass a reference .pth or a checkpoint of train_torch.py")


def set_precision(cfg, precision):
    """``--precision`` into the config, as ``evaluate.py`` does: any but
    float32 (the default, which leaves the config's own key) sets
    ``COMPUTE_DTYPE``."""
    if precision != "float32":
        cfg["COMPUTE_DTYPE"] = precision


def load_state(model_type, cfg, weight, device):
    """The model as ``train_torch.py`` builds it (with the patch decoder where
    the config trains one, so that its checkpoints restore exactly), in a
    train state on ``device``, with ``weight`` loaded: a reference ``.pth``
    through ``compat.load_torch_checkpoint``, else a checkpoint of
    ``train_torch.py``; no ``weight`` leaves the seeded initialisation."""
    import torch

    from patchaugnet_tpu_torch import train
    from patchaugnet_tpu_torch.compat import load_torch_checkpoint
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import training_init_

    model = training_init_(get_model(model_type, cfg), torch.Generator().manual_seed(cfg.get("MANUAL_SEED", 123)))
    state = train.create_train_state(model, cfg, device=device)
    if weight and weight.endswith(".pth"):
        load_torch_checkpoint(weight, model_type, cfg, state.model)
    elif weight:
        state, _ = train.restore_checkpoint(weight, state)
    return state


def eval_forward(model, device, local: bool):
    """The eval's forward: the local one (global, local, centres) when the
    descriptor store wants locals and the model has them, else the global
    one, as ``evaluate.py:166-170`` falls back for PointNetVLAD and
    MinkLoc3Dv2."""
    from patchaugnet_tpu_torch import train

    forward = train.build_local_forward_fn(model, device) if local else None
    return forward if forward is not None else train.build_forward_fn(model, device)


def main(argv=None):
    """Evaluate as ``evaluate.py`` does; returns the eval's result (recall,
    1% recall, descriptor time), with ``test_ds`` (its descriptors in
    ``test_ds.scene.global_descs``), the eval's ``forward`` and
    ``top_k_path`` where the dump went. With ``--devices`` above 1 it
    returns rank 0's result without ``test_ds`` and ``forward``, with
    ``global_descs``, and every rank's under ``ranks``."""
    args = get_args(argv)
    from patchaugnet_tpu_torch.serving import platform_device

    device = platform_device(args.platform)
    refuse_unported(args)
    if args.devices > 1:
        from patchaugnet_tpu_torch import parallel

        ranks = parallel.spawn(_evaluate_rank, args.devices, args=(args,), platform=args.platform,
                               share_device=args.share_device)
        return dict(ranks[0], ranks=ranks)
    return _evaluate(args, device)


def _evaluate_rank(args):
    """One rank of ``--devices N``: what pickles of its result."""
    from patchaugnet_tpu_torch import parallel

    mesh = parallel.make_mesh()
    out = _evaluate(args, mesh.device, mesh)
    out["global_descs"] = out.pop("test_ds").scene.global_descs
    out.pop("forward")
    return out


def _evaluate(args, device, mesh=None):
    """The eval on ``device``; with a ``mesh``, this rank's part of the
    sharded eval (rank 0 alone logs and writes)."""
    import logging

    import torch

    from patchaugnet_tpu_torch import data, parallel, train
    from patchaugnet_tpu_torch.configs import load_config
    from patchaugnet_tpu_torch.utils import get_logger

    lead = mesh is None or mesh.rank == 0
    cfg = load_config(args.config or CONFIG_TABLE[args.model_type])
    cfg["model_type"] = args.model_type
    cfg["dataset"] = args.dataset
    set_precision(cfg, args.precision)

    if lead:
        logger = get_logger(os.path.join(args.exp_dir, args.model_type, "eval"))
    else:
        logger = logging.getLogger(f"patchaugnet_tpu_torch.rank{mesh.rank}")
        logger.disabled = True
    logger.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    ds_kwargs = dict(
        num_pos=cfg.get("EVAL_POSITIVES_PER_QUERY", 4),
        num_neg=cfg.get("EVAL_NEGATIVES_PER_QUERY", 10),
        device=device,
    )
    if cfg["dataset"] == "synthetic":
        # the synthetic scene regenerates at the config's cloud size, as in
        # train_torch.py, so checkpoints evaluate on clouds of their size
        ds_kwargs["num_points"] = cfg["NUM_POINTS"]
    test_ds = data.PlaceRecognitionDataset(cfg["dataset"], for_training=False, **ds_kwargs)
    logger.info(f"test records: {len(test_ds)}, trips: {test_ds.scene.trip_names}")

    # the eval forward never runs the patch decoder
    state = load_state(args.model_type, cfg, args.weight, device)
    if args.weight:
        logger.info(f"loaded weights: {args.weight}")
    else:
        logger.info("no --weight given: evaluating a randomly initialised model")

    # the per-record descriptor store (reference run(), evaluate.py:170
    # save=True); synthetic scenes have no data dir
    save_model_type = (
        args.model_type
        if not args.no_save_descs and args.dataset != "synthetic"
        else None
    )
    if mesh is None:
        forward = eval_forward(state.model, device, local=save_model_type is not None)
    else:
        # the records of each batch split over the ranks, every output
        # gathered back, the store's bytes those of one device
        pfwd = parallel.build_parallel_local_forward(state.model, mesh) if save_model_type else None
        pfwd = pfwd or parallel.build_parallel_forward(state.model, mesh)

        def forward(clouds):
            return pfwd(parallel.shard_batch(mesh, clouds))

        logger.info(f"sharded eval over {mesh.size} devices ({torch.distributed.get_backend()})")
    out = train.evaluate(
        forward, test_ds, top_k=25, batch_size=args.batch_size, logger=logger,
        save_model_type=save_model_type if lead else None,
    )
    out["test_ds"], out["forward"] = test_ds, forward
    if out.get("desc_time"):
        logger.info(
            f"run time: {out['desc_time']['mean_ms']:.2f} +- "
            f"{out['desc_time']['std_ms']:.2f} ms per cloud"
        )
    if not args.no_save_top_k and lead:
        top = test_ds.find_and_save_top(
            model_type=args.model_type, top_k=args.top_k,
            space_type=args.top_k_space,
            save=args.dataset != "synthetic",
        )
        os.makedirs(args.exp_dir, exist_ok=True)
        path = os.path.join(
            args.exp_dir,
            f"top_k_{args.top_k_space}_{args.model_type}_{args.dataset}.pickle",
        )
        with open(path, "wb") as f:
            pickle.dump(top, f)
        out["top_k_path"] = path
        logger.info(f"saved top-k dump: {path}")
    return out


if __name__ == "__main__":
    main()
