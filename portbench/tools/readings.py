#!/usr/bin/env python3
"""The readings that set a cell's limits: its numbers compared, run after
run, for sound runs of the program, for the control, or for a planted
fault (``portbench/faults.py``), on several seeds in one process.

    python3 portbench/tools/readings.py --workload pan.serve.b100 --variant sound --seeds 11,12,13 --seconds 4

Prints one JSON line per seed: the variant, the seed, ``correct`` and the
numbers compared.
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import faults, harness, program  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--variant", default="sound", help="sound, or a fault of portbench/faults.py")
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args()
    harness.set_cache_dirs()
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = harness.prepare(args.workload, seed, args.seconds, False, time.perf_counter())
        planted = (contextlib.nullcontext() if args.variant == "sound"
                   else faults.fault(run.traffic["kind"], args.variant, program.model_config(run)))
        t0 = time.perf_counter()
        with planted:
            result = harness.execute(run)
        print(json.dumps({"variant": args.variant, "seed": seed, "correct": result["correct"],
                          "checks": {k: c["value"] for k, c in result["checks"].items()},
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "record": {k: run.record[k] for k in ("loss_gap_by_step", "excluded_leaves")
                                     if k in run.record},
                          "seconds": time.perf_counter() - t0}), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"readings: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
