#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object. The run
exits with 2 and prints no result when the card the cell asks for is
missing, and with 3 when JAX or the JAX package was loaded.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return max(float(f.read().split()[0]) - started, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    start = START - _process_age_s()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from portbench import harness

    harness.set_cache_dirs()
    try:
        run = harness.prepare(args.workload, args.seed, args.seconds, bool(args.trace), start)
    except harness.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    result = harness.execute(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
