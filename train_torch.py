#!/usr/bin/env python
"""Training CLI of the PyTorch/CUDA port (``patchaugnet_tpu_torch``).

The port's counterpart of ``train.py``, with its flags: ``--config
--dataset --resume --eval``, a YAML config with the reference's keys,
per-epoch checkpoints, the optional per-epoch eval
(``EVAL_EVERY_N_EPOCHS``), ``--max-batches`` to bound an epoch. It runs on
the card; ``--platform cpu`` runs it on the CPU, and without a CUDA device
and without that flag it exits with a message.

It trains ``patch_aug_net``, ``pptnet``, ``pptnet_l2_norm`` and
``pointnet_vlad`` on tuple batches, and with ``LOSS_FUNCTION:
truncatedsmoothap`` (``minkloc3dv2``'s config) runs the SmoothAP trainer
of ``train.py:159-260``: flat pair-expanded batches of
``SMOOTHAP_BATCH_SIZE`` (16) clouds, AdamW at ``WEIGHT_DECAY`` under
MultiStepLR (``scheduler_milestones``, default 250 and 350), a
checkpoint per epoch and an eval every ``EVAL_EVERY_N_EPOCHS`` (1).
``--print-flops`` logs the eval forward's GFLOPs per cloud on a probe of
4 clouds and the parameter table, as ``train.py:199-210`` does (counted by
``utils.flops``: products and convolutions only). ``--precision bfloat16``
trains at that compute dtype (``COMPUTE_DTYPE``: the feature path in bf16,
parameters, optimizer state and BatchNorm statistics f32); ``--remat``
recomputes the forward in the backward (``REMAT``). ``--devices N`` trains
data-parallel over N ranks (``parallel.build_parallel_train_step``), one
process each: every rank draws the same tuple batch from the seed and
loads only its rows of it, runs K1 for the patch centres on them (the
centres gathered, the tables built alike on every rank) and its rows of
each batch of the mining refresh; ``TRAIN_BATCH_SIZE`` is raised until
the flattened batch splits evenly, as ``train.py`` does, and rank 0 alone
logs, writes the events and the checkpoints and runs the per-epoch eval
on its card.
The ranks use NCCL on cards of their own, gloo with ``--platform cpu``,
and gloo on one card with ``--share-device``. TruncatedSmoothAP
(MinkLoc3Dv2) trains on one device: ``--devices`` above 1 is refused
(``train.py`` trains it on one device without a word; ROADMAP C).

Usage:
  python train_torch.py --config configs/patch_aug_net.yaml --dataset oxford
  python train_torch.py --config configs/pptnet_origin.yaml --dataset synthetic --max-batches 5 --epochs 1
  python train_torch.py --config configs/minkloc3dv2.yaml --dataset synthetic --max-batches 5 --epochs 1
  python train_torch.py --config configs/patch_aug_net.yaml --dataset synthetic \
      --max-batches 5 --epochs 1        # no data on disk needed
  python train_torch.py --config configs/tiny_smoke.yaml --dataset synthetic \
      --platform cpu --epochs 1 --max-batches 2
  python train_torch.py --config configs/tiny_smoke.yaml --dataset synthetic \
      --platform cpu --epochs 1 --max-batches 2 --precision bfloat16 --remat
  python train_torch.py --config configs/tiny_smoke.yaml --dataset synthetic \
      --platform cpu --epochs 1 --max-batches 2 --devices 2
  python train_torch.py --config configs/patch_aug_net.yaml --dataset synthetic \
      --epochs 1 --max-batches 2 --devices 2 --share-device   # two ranks on one card
"""
import argparse
import os
import random
import sys
from datetime import datetime

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Point Cloud Place Recognition (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default="configs/patch_aug_net.yaml")
    p.add_argument(
        "--dataset", type=str, default="oxford",
        help="oxford | university | residential | business | hankou | campus |"
             " sejong | dcc_* | kitti360_* | synthetic",
    )
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--eval", action="store_true", help="evaluation only")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel device count: one rank per device")
    p.add_argument("--share-device", action="store_true",
                   help="with --devices above the card count, put the ranks on the cards in turn (over gloo)")
    p.add_argument("--epochs", type=int, default=None, help="override MAX_EPOCH")
    p.add_argument("--max-batches", type=int, default=None,
                   help="cap batches per epoch (smoke runs)")
    p.add_argument("--platform", type=str, default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default: the CUDA card) or cpu")
    p.add_argument("--exp_dir", type=str, default=None,
                   help="override the config EXP_DIR")
    p.add_argument("--num-points", type=int, default=None,
                   help="override NUM_POINTS (and the synthetic scene size)")
    p.add_argument("--synthetic-noise", type=float, default=None,
                   help="synthetic dataset only: per-point gaussian noise stddev added to every scene "
                        "cloud (seeded), so that random-init recall starts low")
    p.add_argument("--print-flops", action="store_true",
                   help="log the forward's GFLOPs per cloud and the parameter table at startup")
    p.add_argument("--precision", type=str, default=None, choices=["float32", "bfloat16"],
                   help="model compute dtype (COMPUTE_DTYPE); parameters stay float32")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward (REMAT): less memory, more forward work")
    return p.parse_args(argv)


def build_cfg(args):
    """The config file with the flags' overrides, and the run's directories."""
    from patchaugnet_tpu_torch.configs import load_config

    cfg = load_config(args.config)
    cfg["dataset"] = args.dataset
    cfg["resume"] = args.resume
    cfg["eval"] = args.eval
    if args.epochs is not None:
        cfg["MAX_EPOCH"] = args.epochs
    if args.exp_dir is not None:
        cfg["EXP_DIR"] = args.exp_dir
    if args.num_points is not None:
        cfg["NUM_POINTS"] = args.num_points
    if args.precision == "float32":
        cfg.pop("COMPUTE_DTYPE", None)
    elif args.precision is not None:
        cfg["COMPUTE_DTYPE"] = args.precision
    if args.remat:
        cfg["REMAT"] = True
    cfg["event_dir"] = os.path.join(
        cfg["EXP_DIR"], cfg["model_type"], "events",
        datetime.now().strftime("%Y-%m-%dT%H-%M-%S"),
    )
    cfg["save_path"] = os.path.join(cfg["EXP_DIR"], cfg["model_type"], "saved_model")
    return cfg


def parallel_batch(cfg, devices: int) -> None:
    """Raise ``TRAIN_BATCH_SIZE`` until the flattened tuple batch splits
    evenly over ``devices`` (``train.py:161-171``); refuse SmoothAP."""
    if cfg.get("LOSS_FUNCTION", "").lower() == "truncatedsmoothap":
        raise ValueError("--devices above 1 with LOSS_FUNCTION truncatedsmoothap: the SmoothAP trainer "
                         "(MinkLoc3Dv2) runs on one device (train.py trains it on one device whatever --devices "
                         "says; ROADMAP C). Data-parallel training (ROADMAP A11) takes the tuple losses.")
    tuple_size = 1 + cfg["TRAIN_POSITIVES_PER_QUERY"] + cfg["TRAIN_NEGATIVES_PER_QUERY"] + 1
    while (cfg["TRAIN_BATCH_SIZE"] * tuple_size) % devices:
        cfg["TRAIN_BATCH_SIZE"] += 1


def _rank_logger(rank: int):
    """A silent logger for the ranks other than 0."""
    import logging

    logger = logging.getLogger(f"patchaugnet_tpu_torch.rank{rank}")
    logger.disabled = True
    return logger


def _rank_fns(model, cfg, mesh, center_fn):
    """What a rank hands the loop, each taking this rank's rows of a batch
    (the loop loads no others): the data-parallel step (``step(state,
    clouds, corr, mask)``, the whole batch's tables and mask), the centres
    of the whole batch (K1 on this rank's rows, gathered), and the mining
    refresh's forward (the whole batch's descriptors)."""
    from patchaugnet_tpu_torch import parallel

    pstep = parallel.build_parallel_train_step(model, cfg, mesh)

    def step(state, clouds, corr, cloud_mask):
        rows = parallel.host_batch_slice(cloud_mask.shape[0], mesh.rank, mesh.size)
        return pstep(state, parallel.make_global_batch(mesh, clouds), corr, cloud_mask[rows])

    centers = None
    if center_fn is not None:
        def centers(clouds):
            return parallel.gather_rows(center_fn(clouds), mesh)

    return step, centers, parallel.build_parallel_forward(model, mesh)


def _train_rank(args, cfg):
    """One rank of ``--devices N``: its mesh, then the run; returns what
    pickles of it (the config, the summaries, the model's state on the
    CPU)."""
    from patchaugnet_tpu_torch import parallel

    mesh = parallel.make_mesh()
    run = _train(args, cfg, mesh.device, mesh)
    return {"cfg": run["cfg"], "summaries": run["summaries"], "rank": mesh.rank,
            "model": {k: v.detach().cpu() for k, v in run["state"].model.state_dict().items()}}


def main(argv=None):
    """Train (or with ``--eval`` evaluate) as ``train.py`` does. Returns the
    run: ``cfg``, ``state``, ``train_ds``, ``test_ds``, ``forward``, the
    per-epoch ``summaries`` and, with ``--eval``, the eval's ``result``.
    With ``--devices`` above 1 it returns rank 0's ``cfg`` and
    ``summaries`` and, under ``ranks``, every rank's ``model`` state on
    the CPU."""
    args = get_args(argv)
    from patchaugnet_tpu_torch.serving import platform_device

    device = platform_device(args.platform)
    cfg = build_cfg(args)
    devices = args.devices or 1
    if devices > 1 and not cfg["eval"]:
        from patchaugnet_tpu_torch import parallel

        parallel_batch(cfg, devices)
        ranks = parallel.spawn(_train_rank, devices, args=(args, cfg), platform=args.platform,
                               share_device=args.share_device)
        return {"cfg": ranks[0]["cfg"], "summaries": ranks[0]["summaries"], "ranks": ranks}
    return _train(args, cfg, device)


def _train(args, cfg, device, mesh=None):
    """The run on ``device``; with a ``mesh``, this rank's part of the
    data-parallel run."""
    import numpy as np
    import torch

    from patchaugnet_tpu_torch import data, train
    from patchaugnet_tpu_torch.models import get_model
    from patchaugnet_tpu_torch.nn import training_init_
    from patchaugnet_tpu_torch.utils import MetricsWriter, get_logger

    lead = mesh is None or mesh.rank == 0
    if lead:
        os.makedirs(cfg["save_path"], exist_ok=True)
    seed = cfg.get("MANUAL_SEED", 123)
    # the host's draws for the correspondence tables and the mining (the
    # JAX CLI seeds the global ``random`` and ``np.random`` with this seed);
    # every rank draws the same
    rng, np_rng = random.Random(seed), np.random.RandomState(seed)

    logger = get_logger(cfg["event_dir"]) if lead else _rank_logger(mesh.rank)
    logger.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if mesh is not None:
        logger.info(f"data-parallel mesh over {mesh.size} devices ({torch.distributed.get_backend()}), "
                    f"TRAIN_BATCH_SIZE {cfg['TRAIN_BATCH_SIZE']} (the flattened batch splits evenly)")
    logger.info(cfg)
    writer = MetricsWriter(cfg["event_dir"]) if lead else None

    # the patch branch is PatchAugNet's: other models ignore the patch flags
    use_patches = cfg["model_type"] == "patch_aug_net" and bool(
        cfg.get("use_patch_recon") or cfg.get("use_patch_feature_contrast"))
    ds_kwargs = dict(
        num_pos=cfg["TRAIN_POSITIVES_PER_QUERY"],
        num_neg=cfg["TRAIN_NEGATIVES_PER_QUERY"],
        device=device,
    )
    if cfg["dataset"] == "synthetic":
        ds_kwargs["num_points"] = cfg["NUM_POINTS"]
    train_ds = data.PlaceRecognitionDataset(
        cfg["dataset"], for_training=True, load_overlap_indices=use_patches, **ds_kwargs,
    )
    test_ds = data.PlaceRecognitionDataset(cfg["dataset"], for_training=False, **ds_kwargs)
    if args.synthetic_noise:
        if cfg["dataset"] != "synthetic":
            raise SystemExit("--synthetic-noise requires --dataset synthetic")
        for ds in (train_ds, test_ds):
            r = np.random.RandomState(7)
            ds.scene._clouds = ds.scene._clouds + (
                r.randn(*ds.scene._clouds.shape).astype(np.float32) * args.synthetic_noise
            )
            ds.scene._pc_cache.clear()
        logger.info(f"synthetic scene hardened: noise {args.synthetic_noise}")
    logger.info(
        f"train records: {len(train_ds)}, test records: {len(test_ds)}, "
        f"trips: {train_ds.scene.trip_names}"
    )

    model = training_init_(get_model(cfg["model_type"], cfg), torch.Generator().manual_seed(seed))
    steps_per_epoch = max(len(train_ds) // cfg["TRAIN_BATCH_SIZE"], 1)
    use_smoothap = cfg.get("LOSS_FUNCTION", "").lower() == "truncatedsmoothap"
    smoothap_step = tx = None
    if use_smoothap:
        # the MinkLoc3Dv2 pipeline: AdamW and MultiStepLR built up front
        # (config_baseline.txt lr, weight_decay, scheduler_milestones)
        schedule = train.multistep_schedule(cfg["BASE_LEARNING_RATE"], cfg.get("scheduler_milestones", [250, 350]),
                                            steps_per_epoch)
        smoothap_step, tx = train.build_smoothap_train_step(
            model, schedule, weight_decay=cfg.get("WEIGHT_DECAY"), tau1=cfg.get("tau1", 0.01),
            positives_per_query=cfg.get("positives_per_query", 4))
    state = train.create_train_state(model, cfg, steps_per_epoch=steps_per_epoch, device=device, tx=tx)
    logger.info(f"Parameters: {sum(p.numel() for p in state.model.parameters()):,}")
    if args.print_flops and lead:
        # the reference prints fvcore's GFLOPs on a 4 x 4096 x 3 probe at
        # startup (train_place_recognition.py:551-553)
        from patchaugnet_tpu_torch.utils import flops, parameter_count

        probe = torch.zeros((4, cfg["NUM_POINTS"], 3), device=device)
        forward = train.build_forward_fn(state.model, device)
        logger.info(f"FLOPs: {flops(forward, probe) / 4 / 1e9:.4f} GFLOPs/cloud (products and convolutions)")
        logger.info(f"Parameter table: {parameter_count(state.model)}")

    starting_epoch = 0
    if cfg["resume"]:
        path = cfg["resume"]
        if not os.path.exists(path):
            path = os.path.join(cfg["save_path"], cfg["resume"])
        state, starting_epoch = train.restore_checkpoint(path, state)
        logger.info(f"Resumed from {path} at epoch {starting_epoch}")

    forward = train.build_forward_fn(state.model, device)
    center_fn = train.build_center_fn(cfg["SAMPLING"][0], device) if use_patches else None
    if mesh is not None:
        step, center_fn, refresh_fn = _rank_fns(state.model, cfg, mesh, center_fn)
    else:
        step = None if use_smoothap else train.build_train_step(state.model, cfg)
        refresh_fn = forward
    run = {"cfg": cfg, "state": state, "train_ds": train_ds, "test_ds": test_ds, "forward": forward,
           "summaries": []}

    if cfg["eval"]:
        run["result"] = train.evaluate(forward, test_ds, logger=logger, writer=writer, epoch=starting_epoch)
        writer.close()
        return run

    if use_smoothap:
        # flat batches and (B, B) masks, a checkpoint and (by default) an
        # eval every epoch, as train.py's SmoothAP path
        eval_every = cfg.get("EVAL_EVERY_N_EPOCHS", 1)
        for epoch in range(starting_epoch, cfg["MAX_EPOCH"]):
            logger.info(f"**** EPOCH {epoch:03d} (SmoothAP) ****")
            state, summary = train.train_one_epoch_smoothap(
                state, smoothap_step, train_ds.scene, batch_size=cfg.get("SMOOTHAP_BATCH_SIZE", 16),
                batches_per_epoch=args.max_batches or steps_per_epoch, rng=rng, logger=logger)
            writer.add_scalars("epoch_loss", {f"train_{k}": v for k, v in summary.items()}, epoch + 1)
            train.save_checkpoint(cfg["save_path"], state, epoch)
            run["summaries"].append(summary)
            if (epoch + 1) % eval_every == 0 and len(test_ds) > 0:
                train.evaluate(forward, test_ds, logger=logger, writer=writer, epoch=epoch)
        writer.close()
        run["state"] = state
        return run

    total_iterations = 0
    # the reference evals only on --eval (its per-epoch eval is commented
    # out, train_place_recognition.py:564-566); EVAL_EVERY_N_EPOCHS turns
    # it back on, as in the JAX CLI
    eval_every = cfg.get("EVAL_EVERY_N_EPOCHS", 0)
    for epoch in range(starting_epoch, cfg["MAX_EPOCH"]):
        logger.info(f"**** EPOCH {epoch:03d} ****")
        summary = train.train_one_epoch(
            state, step, train_ds, cfg, epoch, rng, np_rng,
            forward_fn=refresh_fn, center_fn=center_fn, writer=writer,
            logger=logger, total_iterations=total_iterations,
            max_batches=args.max_batches, save_dir=cfg["save_path"] if lead else None,
            shard=None if mesh is None else (mesh.rank, mesh.size),
        )
        state = summary.pop("state")
        total_iterations = summary["total_iterations"]
        run["summaries"].append(summary)
        logger.info(f"epoch {epoch}: {summary}")
        if lead and eval_every and (epoch + 1) % eval_every == 0 and len(test_ds) > 0:
            train.evaluate(forward, test_ds, logger=logger, writer=writer, epoch=epoch)
    if writer is not None:
        writer.close()
    run["state"] = state
    return run


if __name__ == "__main__":
    main()
