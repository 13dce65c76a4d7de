"""The per-layer metrics read from the program's own spans and counters
(``host_ms``, ``bwd_host_ms``, ``prep_builds``): what they read from
``profiling.collected()``, None where the program recorded nothing or has
no spans at all (a parent without them), and a traced run of each cell on
the CPU that reports its new metrics."""

from __future__ import annotations

import pytest

from aec_bench.bench import load_module
from aec_bench.tests.helpers import REPO, run_cell, tiny_root
from aec_tpu_torch.kernels import hop
from aec_tpu_torch.utils import profiling


def reader(name):
    return load_module(REPO, "metrics", name).read


def reading(driver):
    return {"trace": None, "cfg": {}, "mix": {"driver": driver}, "work": {}, "host": {}}


def spans(names, builds=()):
    """One root span a name under ``collect()``; ``builds[i]`` rebuilds
    counted inside the i-th."""
    with profiling.collect():
        for i, name in enumerate(names):
            with profiling.span(name):
                with profiling.span(name + ".child"):
                    if i < len(builds):
                        hop.prepare.builds += builds[i]


@pytest.mark.parametrize("driver,root", [("bulk", "two_stage"), ("train", "train.step"),
                                         ("serve", "serving.step"), ("infer", "enhance")])
def test_host_ms_reads_the_cells_root_span(driver, root):
    spans([root] * 3 + ["other"])
    got = reader("host_ms")(reading(driver))
    assert got == profiling.collected()["summary"][root]["median_ms"] and got > 0
    spans(["other"])
    assert reader("host_ms")(reading(driver)) is None


def test_bwd_host_ms_reads_train_backward():
    spans(["train.backward", "train.backward"])
    assert reader("bwd_host_ms")(reading("train")) == \
        profiling.collected()["summary"]["train.backward"]["median_ms"]
    profiling.reset()
    assert reader("bwd_host_ms")(reading("train")) is None


def test_prep_builds_per_thousand_calls(monkeypatch):
    monkeypatch.setattr(hop.prepare, "builds", hop.prepare.builds)
    spans(["serving.step"] * 4, builds=(1, 0, 0, 1))
    assert reader("prep_builds")(reading("serve")) == 500.0
    spans(["serving.step"] * 2)
    assert reader("prep_builds")(reading("serve")) == 0.0
    spans(["two_stage"])
    assert reader("prep_builds")(reading("serve")) is None


@pytest.mark.parametrize("name", ["host_ms", "bwd_host_ms", "prep_builds"])
def test_a_program_without_spans_reads_none(monkeypatch, name):
    spans(["two_stage", "train.step", "train.backward", "serving.step", "enhance"])
    monkeypatch.delattr(profiling, "collected")
    for driver in ("bulk", "train", "serve", "infer"):
        assert reader(name)(reading(driver)) is None


@pytest.mark.parametrize("cell,metrics", [
    ("littlenet_kalman.bulk", {"host_ms.bulk"}),
    ("littlenet_kalman.serve", {"host_ms.serve", "prep_builds.serve"}),
    ("dccrn.infer", {"host_ms.infer"}),
    ("dccrn.train", {"host_ms.train", "bwd_host_ms.train"}),
])
def test_traced_run_reports_the_new_metrics(tmp_path, cell, metrics):
    code, line, err = run_cell(tiny_root(tmp_path), cell, traced=True)
    assert code == 0, err
    assert metrics <= set(line["metrics"])
    if "prep_builds.serve" in metrics:
        assert line["metrics"]["prep_builds.serve"]["value"] == 0.0
    names = {n for kind in ("device_ops", "idle_gaps") for n, _ in line["breakdown"][kind]}
    assert not [n for n in names if n.startswith(("two_stage", "serving.", "enhance", "train."))]
