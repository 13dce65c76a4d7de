"""The benchmark's command: one run of one cell.

    python3 -m aec_bench.run --workload littlenet_kalman.bulk --seed 7 --seconds 20 --trace 0

Run it from the root of a checkout (it reads ``BENCHMARK.json`` there) on a
machine with the CUDA cards the cell asks for; it exits non-zero and prints
no result without them. The last line of standard output is the result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from aec_bench.bench import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
