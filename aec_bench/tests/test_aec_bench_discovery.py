"""A configuration, a traffic mix and a per-layer metric added as new files,
with entries in BENCHMARK.json and no edit to any file there, are found by
name."""

from __future__ import annotations

import json
import shutil

from aec_bench.tests.helpers import run_cell, tiny_root

READER = '''"""A new per-layer metric: the batches the traced window ran."""


def read(r):
    return float(r["work"]["batches"])
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tiny_root(tmp_path)
    bench_dir = root / "aec_bench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.loads((bench_dir / "configs" / "littlenet_kalman.json").read_text())
    cfg["name"] = "littlenet_kalman_b"
    (bench_dir / "configs" / "littlenet_kalman_b.json").write_text(json.dumps(cfg))
    for kind in ("reference", "counts"):
        shutil.copy(bench_dir / kind / "littlenet_kalman.py",
                    bench_dir / kind / "littlenet_kalman_b.py")
    mix = json.loads((bench_dir / "traffic" / "bulk.json").read_text())
    mix["batch"] = 2
    (bench_dir / "traffic" / "bulk_pairs.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "batches_seen.py").write_text(READER)
    (bench_dir / "checks" / "littlenet_kalman_b.bulk_pairs.json").write_text(
        (bench_dir / "checks" / "littlenet_kalman.bulk.json").read_text())
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = "littlenet_kalman_b.bulk_pairs"
    manifest["configs"].append({"name": "littlenet_kalman_b", "source": "a test",
                                "file": "aec_bench/configs/littlenet_kalman_b.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": cell, "config": "littlenet_kalman_b",
                                  "traffic": "bulk_pairs", "chips": 1, "why": "a test"})
    manifest["end_to_end"][0]["workloads"].append(cell)
    manifest["per_layer"].append({"name": "batches_seen.bulk", "unit": "count",
                                  "better": "higher", "source": "host_clock", "layer": "test",
                                  "moves": "xrt", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for p, data in before.items():
        assert p.read_bytes() == data  # nothing that was there is edited

    code, line, err = run_cell(root, cell)
    assert code == 0 and line["correct"], err
    assert set(line["metrics"]) == {"xrt", "setup_s"}
    code, line, err = run_cell(root, cell, traced=True)
    assert code == 0, err
    assert line["metrics"]["batches_seen.bulk"]["value"] == line["attempted"]
