#!/usr/bin/env python
"""Real-data parity harness of the PyTorch/CUDA port: one command from a
data mount and a reference checkpoint to a per-trip-pair recall diff.

The port's counterpart of ``parity_harness.py``:

  PCR_DATA_ROOT=/mnt/benchmark_datasets python parity_harness_torch.py \\
      --model_type patch_aug_net --weight ref_train_epoch_29_end.pth \\
      --dataset oxford --reference-log ref_eval.log

It (1) imports the checkpoint (a reference ``.pth`` through
``compat.load_torch_checkpoint``, or a checkpoint of ``train_torch.py``),
(2) runs the reference eval protocol through the port's data engine
(whole-database descriptor extraction at batch 100, per-trip-pair
recall@1..25 and @1% with the reference's bookkeeping,
the reference's place_recognition/evaluate.py:167-237), (3) prints the
port's side in the reference's log format, and (4) with
``--reference-log``, parses the reference run's log (the ``Recall@top1~25``
and ``Recall@top1%`` lines its logger writes) and prints the per-pair
delta table, exiting non-zero when any |delta| exceeds ``--tolerance``
recall points. It runs on the card; ``--platform cpu`` runs it on the
CPU.
"""
import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from evaluate_torch import CONFIG_TABLE

_PAIR_RE = re.compile(r"Recall @topN: query:(?P<q>[^,]+), database:(?P<db>[^,]+),")
_RECALL_RE = re.compile(r"Recall@top1~\d+: \[(?P<vals>[^\]]+)\]")
_OPR_RE = re.compile(r"Recall@top1%\(=\d+\): (?P<v>[-\d.eE]+)")


def parse_reference_log(path):
    """Reference eval log -> {(query_trip, db_trip): {recall, opr}}, from
    exactly what the reference logger writes (evaluate.py:196-202); numpy
    array strings may span lines."""
    with open(path) as f:
        text = f.read()
    # numpy wraps long arrays across lines inside [...]: join them
    text = re.sub(r"\[\s*([^\]]*?)\s*\]", lambda m: "[" + " ".join(m.group(1).split()) + "]", text, flags=re.S)
    pairs = {}
    current = None
    for line in text.splitlines():
        m = _PAIR_RE.search(line)
        if m:
            current = (m.group("q").strip(), m.group("db").strip())
            pairs[current] = {}
            continue
        if current is None:
            continue
        m = _RECALL_RE.search(line)
        if m and "recall" not in pairs[current]:
            pairs[current]["recall"] = [float(v) for v in m.group("vals").split()]
            continue
        m = _OPR_RE.search(line)
        if m and "opr" not in pairs[current]:
            pairs[current]["opr"] = float(m.group("v"))
    return {k: v for k, v in pairs.items() if "recall" in v}


def diff(ours, ref, tolerance):
    """Print the per-pair delta table of ``ours`` against ``ref`` (both as
    :func:`parse_reference_log` returns them); returns (status, diffs),
    status 1 when a pair is missing on either side or any |delta| exceeds
    ``tolerance`` recall points."""
    import numpy as np

    print("\n================ PARITY DIFF vs reference log ================")
    print(f"{'query':20s} {'database':20s} {'dR@1':>8s} {'dR@1%':>8s} {'max|dR|':>8s}")
    status, diffs = 0, {}
    for key, mine in ours.items():
        if key not in ref:
            print(f"{key[0]:20s} {key[1]:20s}   -- pair missing from reference log --")
            status = 1
            continue
        r = ref[key]
        n = min(len(mine["recall"]), len(r["recall"]))
        dr = np.array(mine["recall"][:n]) - np.array(r["recall"][:n])
        dopr = mine["opr"] - r.get("opr", mine["opr"])
        print(f"{key[0]:20s} {key[1]:20s} {dr[0]:8.2f} {dopr:8.2f} {np.abs(dr).max():8.2f}")
        diffs[f"{key[0]}|{key[1]}"] = {"d_recall_at_1": float(dr[0]), "d_one_percent": float(dopr),
                                       "max_abs_d_recall": float(np.abs(dr).max())}
        if np.abs(dr).max() > tolerance or abs(dopr) > tolerance:
            status = 1
    for key in sorted(set(ref) - set(ours)):
        print(f"{key[0]:20s} {key[1]:20s}   -- pair missing from our run --")
        status = 1
    return status, diffs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_type", default="patch_aug_net", choices=sorted(CONFIG_TABLE))
    p.add_argument("--config", default=None)
    p.add_argument("--weight", default=None, help="reference .pth or checkpoint of train_torch.py")
    p.add_argument("--dataset", default="oxford")
    p.add_argument("--reference-log", default=None, help="reference eval log to diff against")
    p.add_argument("--batch_size", type=int, default=100, help="reference protocol batch (evaluate.py:170)")
    p.add_argument("--top_k", type=int, default=25)
    p.add_argument("--tolerance", type=float, default=1.0, help="max |recall delta| in points before failing")
    p.add_argument("--out", default=None, help="write a JSON report here")
    p.add_argument("--platform", type=str, default="gpu", choices=["gpu", "cpu"],
                   help="gpu (the default: the CUDA card) or cpu")
    args = p.parse_args(argv)
    from patchaugnet_tpu_torch.serving import platform_device

    device = platform_device(args.platform)

    import numpy as np

    from patchaugnet_tpu_torch import data, train
    from patchaugnet_tpu_torch.configs import load_config

    from evaluate_torch import load_state

    cfg = load_config(args.config or CONFIG_TABLE[args.model_type])
    cfg["model_type"] = args.model_type
    cfg["dataset"] = args.dataset
    ds_kwargs = dict(num_pos=cfg.get("EVAL_POSITIVES_PER_QUERY", 4), num_neg=cfg.get("EVAL_NEGATIVES_PER_QUERY", 10),
                     device=device)
    if args.dataset == "synthetic":
        ds_kwargs["num_points"] = cfg["NUM_POINTS"]
    test_ds = data.PlaceRecognitionDataset(args.dataset, for_training=False, **ds_kwargs)
    state = load_state(args.model_type, cfg, args.weight, device)
    print(f"loaded weights: {args.weight}" if args.weight else "WARNING: no --weight: random init (smoke mode)")

    test_ds.update_global_descs(train.build_forward_fn(state.model, device), batch_size=args.batch_size,
                                stat_time=True)
    results = test_ds.get_recall_precision(top_k=args.top_k)

    trip_names = test_ds.scene.trip_names
    ours = {}
    print(f">>>>>>>>>>>>>>>>>>>> Evaluation of {args.model_type} <<<<<<<<<<<<<<<<<<<<")
    for (qt, rt), res in sorted(results.items()):
        if qt == rt or res.num_evaluated == 0:
            continue
        q_name, db_name = trip_names[qt], trip_names[rt]
        ours[(q_name, db_name)] = {"recall": [float(v) for v in res.recall], "opr": float(res.one_percent_recall)}
        # the reference logger's line shapes (evaluate.py:196-202)
        print("--------------------Recall & Precision Results--------------------")
        print(f"Recall @topN: query:{q_name}, database:{db_name}, data dir:{test_ds.scene.data_dir()}")
        print(f"Num of Query: {res.num_evaluated}, Num of Ref: {res.num_database}")
        print(f"Recall@top1~{args.top_k}: {np.array(res.recall)}")
        print(f"Recall@top1%(={res.threshold}): {res.one_percent_recall}")
        print(f"Precision@top1~{args.top_k}: {np.array(res.precision)}")

    report = {"pairs": {f"{q}|{db}": v for (q, db), v in ours.items()}}
    status = 0
    if args.reference_log:
        status, report["diffs"] = diff(ours, parse_reference_log(args.reference_log), args.tolerance)
        report["parity"] = "PASS" if status == 0 else "FAIL"
        print(f"\nPARITY: {report['parity']} (tolerance {args.tolerance} recall points)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report: {args.out}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
