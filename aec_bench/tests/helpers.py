"""A copy of the benchmark at tiny sizes, and a run of one of its cells on the
CPU through the harness (the card's look skipped, the program's plain routes)."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
TINY = {
    "bulk": {"batch": 3, "seconds": 0.512, "pool": 2},
    "train": {"batch": 2, "seconds": 0.256, "pool": 4},
    "serve": {"streams": 9, "ring_ticks": 40, "check_streams": 4},
    "infer": {"seconds": 0.512, "pool": 1, "check_utterances": 1},
}


def tiny_root(tmp: Path) -> Path:
    """``BENCHMARK.json`` and ``aec_bench/`` copied under ``tmp``, every
    traffic mix cut to ``TINY``'s sizes."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "aec_bench", root / "aec_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    for p in (root / "aec_bench" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(TINY.get(mix["driver"], {}))
        p.write_text(json.dumps(mix))
    return root


def run_cell(root: Path, cell: str, *, seconds: float = 0.6, traced: bool = False,
             seed: int = 2**31 + 11) -> tuple[int, dict | None, str]:
    """(exit code, the result line or None, standard error) of one run on
    the CPU."""
    from aec_bench.bench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = run(cell, seed, seconds, traced, time.perf_counter(), root=root,
                   device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines and code == 0 else None), err.getvalue()
