"""The benchmark's data-parallel driver (``aec_bench/drivers/train_dp.py``,
traffic ``train_dp4``) on gloo ranks on the CPU: a narrow DCCRN with
BatchNorm on 2 ranks, rank 0 in this process and rank 1 spawned, checked
against the single-process reference on the global batch; a rank that
fails to start makes the run exit non-zero, soon, rather than hang.

``BENCHMARK.json`` holds no cell on this driver yet: its limits want sound
four-card runs, a TF32 control and a dropped gradient sum read on the
cards. The test's checkout adds the cell ``dccrn.train_dp4`` and gives it
``dccrn.train``'s limits, which a sum over the ranks must meet on the CPU.

The file imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

from aec_bench.tests.helpers import REPO, tiny_root

CELL = "dccrn.train_dp4"


def dp_root(tmp_path, ranks=2):
    """A tiny checkout with the cell: DCCRN's convs narrowed to (4, 8, 16)
    channels, 2 x 0.256 s a rank, ``ranks`` ranks."""
    root = tiny_root(tmp_path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": CELL, "config": "dccrn", "traffic": "train_dp4",
                                  "chips": 4, "why": "data-parallel DCCRN"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_xrt":
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    checks = root / "aec_bench" / "checks"
    (checks / f"{CELL}.json").write_text((checks / "dccrn.train.json").read_text())
    cfg_path = root / "aec_bench" / "configs" / "dccrn.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["net"]["conv_channels"] = [4, 8, 16]
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "aec_bench" / "traffic" / "train_dp4.json"
    mix = json.loads(mix_path.read_text())
    mix.update(ranks=ranks, batch=2, seconds=0.256, pool=4, setup_timeout_s=120,
               step_timeout_s=60)
    mix_path.write_text(json.dumps(mix))
    return root


def run_cpu(root, script: str, timeout: float = 300) -> subprocess.CompletedProcess:
    """``script`` in a fresh process from ``root`` (this one has loaded JAX,
    which a run refuses), the repository on its path."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)], cwd=root,
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_gloo_ranks_match_the_reference_on_the_global_batch(tmp_path):
    root = dp_root(tmp_path)
    proc = run_cpu(root, f"""
        import sys, time, torch
        from pathlib import Path
        from aec_bench.bench import run
        sys.exit(run({CELL!r}, 2**31 + 11, 0.6, False, time.perf_counter(),
                     root=Path({str(root)!r}), device=torch.device("cpu")))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], proc.stderr[-3000:]
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "step_gap", "bn_gap"}
    assert set(line["metrics"]) == {"train_xrt", "setup_s"}
    gaps = {k: v["value"] for k, v in line["checks"].items()}
    # the gradients summed over the ranks, not averaged (a mean would read
    # ~0.5), and the losses the global batch's
    assert gaps["grad_gap"] < 1e-5 and gaps["loss_gap"] < 1e-5, gaps


def test_a_rank_that_fails_to_start_ends_the_run(tmp_path):
    """Rank 1's command exits at once: rank 0, waiting for the group, exits
    non-zero within a minute."""
    root = dp_root(tmp_path)
    script = f"""
        import sys, torch
        from aec_bench import bench
        root = {str(root)!r}
        from pathlib import Path
        ctx, _ = bench.context(Path(root), {CELL!r}, 5, torch.device("cpu"))
        drv = bench.load_module(Path(root), "drivers", ctx.mix["driver"])
        drv.child_argv = lambda *a: [sys.executable, "-c", "raise SystemExit(7)"]
        drv.Cell(ctx)
        print("set-up returned", flush=True)
    """
    t0 = time.monotonic()
    proc = run_cpu(root, script, timeout=120)
    assert proc.returncode != 0 and "set-up returned" not in proc.stdout
    assert "rank 1 exited with 7" in proc.stderr
    assert time.monotonic() - t0 < 60
