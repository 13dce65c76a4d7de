"""The serving cell's knee: the largest stream count at which the p95 tick
latency stays under the tick and the backlog does not grow.

    python3 -m aec_bench.tools.serve_sweep --streams 20000 40000 60000 --seconds 4

For each S, in one process: the serving cell's set-up at S streams, then an
open-loop window (no check). Prints per S the p50, p95, p99 and largest tick
latency, the p95 of how late ticks were issued, and the growth of the
latency from the window's first tenth to its last (a growing backlog).
Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="littlenet_kalman.serve")
    ap.add_argument("--streams", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from aec_bench import bench
    from aec_bench.drivers.common import percentile

    root = Path.cwd()
    bench.set_environment(root)
    import torch

    if not torch.cuda.is_available():
        print("serve_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from aec_bench.trace import Window

    for s in args.streams:
        ctx, _ = bench.context(root, args.workload, args.seed, torch.device("cuda", 0))
        ctx.extra["streams"] = s
        bench.set_precision(ctx.cfg)
        cell = bench.load_module(root, "drivers", ctx.mix["driver"]).Cell(ctx)
        with Window(False) as win:
            res = cell.window(args.seconds, win)
        lat, late = res["host"]["latency_s"], res["host"]["late_s"]
        tenth = max(1, len(lat) // 10)
        print(json.dumps({
            "streams": s, "ticks": len(lat), "ring": cell.ring,
            "p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * percentile(lat, 95),
            "p99_ms": 1e3 * percentile(lat, 99), "max_ms": 1e3 * max(lat),
            "late_p95_ms": 1e3 * percentile(late, 95),
            "growth_ms": 1e3 * (sum(lat[-tenth:]) - sum(lat[:tenth])) / tenth}), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
