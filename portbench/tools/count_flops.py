#!/usr/bin/env python3
"""Print the model FLOPs per item of a cell, counted on the plain reference
(``portbench/flops.py``), for its ``workloads/<cell>.json``.

    python3 portbench/tools/count_flops.py --workload pan.serve.b100
"""
import argparse
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import flops, harness  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    args = parser.parse_args()
    run = harness.prepare(args.workload, 0, 0, False, 0.0, device="cpu")
    from portbench import program

    ref, cfg = program.reference(run), program.model_config(run)
    if run.traffic["kind"] == "serve":
        value = flops.forward_flops(ref, cfg, run.traffic["points"])
    else:
        value = flops.train_flops_per_cloud(ref, cfg, run.traffic["points"])
    print(f"{args.workload}: model_flops_per_item {value!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
