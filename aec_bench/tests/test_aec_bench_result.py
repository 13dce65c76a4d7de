"""The result line and the run's refusals: its keys, the checks last, the
JAX guard compared by whole top-level names, no result without the program
or without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from aec_bench import bench
from aec_bench.tests.helpers import REPO, run_cell, tiny_root


def test_last_line_keys(tmp_path):
    code, line, err = run_cell(tiny_root(tmp_path), "littlenet_kalman.bulk")
    assert code == 0, err
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"xrt", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and f"check {name}:" in err
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_line_has_per_layer_and_breakdown(tmp_path):
    code, line, err = run_cell(tiny_root(tmp_path), "littlenet_kalman.bulk", traced=True)
    assert code == 0, err
    assert "breakdown" in line and set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "xrt" not in line["metrics"]  # the traced run reports per-layer metrics only
    assert "mfu.bulk" in line["metrics"]


@pytest.mark.parametrize("loaded,found", [
    (["jax"], ["jax"]), (["jax.numpy"], ["jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax"], ["flax"]), (["aec_tpu.ops"], ["aec_tpu.ops"]), (["aec_tpu_torch.ops"], []),
    (["jaxtyping"], []),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, loaded, found):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert [m for m in bench.forbidden_modules() if m in loaded] == found


def test_a_run_that_loads_jax_prints_no_result(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    code, line, err = run_cell(tiny_root(tmp_path), "littlenet_kalman.bulk")
    assert code != 0 and line is None and "jax" in err


def _bare_run(cwd, env_extra=None):
    cmd = [sys.executable, "-m", "aec_bench.run", "--workload", "littlenet_kalman.bulk",
           "--seed", "5", "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _bare_run(REPO)  # this machine has no CUDA card
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is not there, so the run fails before any result (the card's
    look skipped)."""
    root = tiny_root(tmp_path)
    assert json.loads((root / "BENCHMARK.json").read_text())["paths"] == ["aec_bench"]
    code = ("import sys, time, torch; from aec_bench.bench import run; sys.exit(run("
            "'littlenet_kalman.bulk', 5, 0.5, False, time.perf_counter(), "
            "device=torch.device('cpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "aec_tpu_torch" in proc.stderr
    assert not proc.stdout.strip()
