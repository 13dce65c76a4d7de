"""The two readings each limit of ``correct`` is set from, for one cell.

    python3 -m aec_bench.tools.readings --workload littlenet_kalman.bulk \
        --seeds 1 2 3 ... --control 1 2 3 [--seconds 3] [--out FILE]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, the program freed, and the check's numbers (the program's
reading); for the ``--control`` seeds also the control's numbers on the same
inputs: the plain reference in TF32 (the precision below the configuration's
float32) put in the program's place. Prints one JSON line per seed and a
summary: the largest program reading and the smallest control reading of
each number. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--half", type=int, nargs="*", default=[],
                    help="seeds on which to read the fault 'half of the batch left out' "
                         "(a training cell: the reference on half of each batch)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from aec_bench import bench

    root = Path.cwd()
    bench.set_environment(root)
    import torch

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    from aec_bench.trace import Window

    rows = []
    for seed in args.seeds:
        ctx, _ = bench.context(root, args.workload, seed, torch.device("cuda", 0))
        bench.set_precision(ctx.cfg)
        t = time.perf_counter()
        cell = bench.load_module(root, "drivers", ctx.mix["driver"]).Cell(ctx)
        setup = time.perf_counter() - t
        with Window(False) as win:
            res = cell.window(args.seconds, win)
        cell.release()
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        row = {"seed": seed, "setup_s": setup, "e2e": res["e2e"], "attempted": res["attempted"],
               "program": cell.check()}
        row["check_s"] = time.perf_counter() - t
        if hasattr(cell, "detail"):
            row["program_leaves"] = cell.detail
        if seed in args.control:
            row["control"] = cell.check(control=True)
            if hasattr(cell, "detail"):
                row["control_leaves"] = cell.detail
        if seed in args.half:
            row["half"] = cell.check(fault="half")
            row["half_leaves"] = cell.detail
        rows.append(row)
        print(json.dumps(row), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for name in rows[0]["program"]:
        prog = [r["program"][name] for r in rows]
        ctrl = [r["control"][name] for r in rows if "control" in r]
        summary[name] = {"program_max": max(prog), "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
