"""Two sets of runs of one cell, each run a process of its own as the check
makes them, and the spread of each end-to-end metric.

    python3 -m aec_bench.tools.sets --workload littlenet_kalman.bulk \
        --seeds 11 12 13 14 15 16 --traced 17 18 19 [--seconds 20] [--out FILE]

Runs set A (one run per seed), then set B (the same seeds again), then one
traced run per ``--traced`` seed. For each metric and set: the median and the
spread, the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median; and each
metric's wider spread of the two sets, which a bound is set from (about five
times the widest spread over the cells, never under 1 %). Needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def one_run(workload: str, seed: int, seconds: float, traced: bool) -> dict:
    cmd = [sys.executable, "-m", "aec_bench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(int(traced))]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    if line is None:
        sys.stderr.write(proc.stderr[-4000:])
    return {"seed": seed, "traced": traced, "rc": proc.returncode, "wall_s": wall, "line": line}


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    runs = {"A": [], "B": [], "traced": []}
    for name in ("A", "B"):
        for seed in args.seeds:
            r = one_run(args.workload, seed, args.seconds, False)
            runs[name].append(r)
            print(json.dumps({"set": name, **r}), flush=True)
    for seed in args.traced:
        r = one_run(args.workload, seed, args.seconds, True)
        runs["traced"].append(r)
        print(json.dumps({"set": "traced", **r}), flush=True)
    summary = {}
    good = all(r["line"] and r["line"]["correct"] for rs in runs.values() for r in rs)
    for name in ("A", "B"):
        lines = [r["line"] for r in runs[name] if r["line"]]
        if len(lines) < 2:
            continue
        for metric in lines[0]["metrics"]:
            vals = [ln["metrics"][metric]["value"] for ln in lines]
            # the first run of a set may compile: its set-up is recorded apart
            ref = vals[1:] if metric == "setup_s" and name == "A" else vals
            summary.setdefault(metric, {})[name] = {
                "median": statistics.median(ref), "spread": spread(ref) if len(ref) > 2 else None,
                "values": vals}
    for metric, sets in summary.items():
        spreads = [s["spread"] for s in sets.values() if s["spread"] is not None]
        sets["wider_spread"] = max(spreads) if spreads else None
    print(json.dumps({"summary": summary, "all_correct": good}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
