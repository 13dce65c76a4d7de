"""BENCHMARK.json against the benchmark's contract: names, units, keys, the
files each entry names, and the check's budget."""

from __future__ import annotations

import json
import re

import pytest

from aec_bench.tests.helpers import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
M = json.loads((REPO / "BENCHMARK.json").read_text())


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(one_line(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_keys_and_names(section, keys):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert one_line(e[k]), (k, e[k])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_configs_files():
    for c in M["configs"]:
        assert c["file"].startswith("aec_bench/") and PATH.match(c["file"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert (REPO / "aec_bench" / "reference" / f"{c['name']}.py").is_file()
        assert (REPO / "aec_bench" / "counts" / f"{c['name']}.py").is_file()
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_cells():
    configs = {c["name"] for c in M["configs"]}
    assert 1 <= len(M["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(M["workloads"])
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        mix = json.loads((REPO / "aec_bench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "aec_bench" / "drivers" / f"{mix['driver']}.py").is_file()
        assert (REPO / "aec_bench" / "checks" / f"{w['name']}.json").is_file()


def test_metrics_cover_every_cell():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in M["workloads"]]
    for m in M["per_layer"]:
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (REPO / "aec_bench" / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        for c in m.get("workloads", cells):
            assert c in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or c in moved["workloads"]
    for c in cells:
        reported = [n for n, m in e2e.items() if "workloads" not in m or c in m["workloads"]]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(c in m.get("workloads", cells) for m in M["per_layer"])


def test_layers_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer
