"""The tail and rate arithmetic: the percentile, and a stall injected into
the timed path moving ``hop_p95_ms`` and ``xrt`` as it should."""

from __future__ import annotations

import time

import pytest

from aec_bench.drivers.common import percentile
from aec_bench.tests.helpers import run_cell, tiny_root


@pytest.mark.parametrize("values,q,want", [
    ([5.0], 95, 5.0), (list(range(1, 101)), 95, 95), (list(range(1, 101)), 50, 50),
    (list(range(1, 21)), 95, 19), ([3.0, 1.0, 2.0], 100, 3.0),
])
def test_nearest_rank_percentile(values, q, want):
    assert percentile(values, q) == want


def stalled(fn, every: int, seconds: float):
    calls = [0]

    def call(*a, **k):
        calls[0] += 1
        if calls[0] % every == 0:
            time.sleep(seconds)
        return fn(*a, **k)

    return call


def test_a_stall_moves_the_serving_tail(tmp_path, monkeypatch):
    from aec_tpu_torch.kernels import serving

    root = tiny_root(tmp_path)
    _, calm, _ = run_cell(root, "littlenet_kalman.serve", seconds=1.6)
    # one tick in 10 stalls for 100 ms: the ticks after it fall due behind it
    monkeypatch.setattr(serving, "serving_step_fused",
                        stalled(serving.serving_step_fused, 10, 0.1))
    _, slow, _ = run_cell(root, "littlenet_kalman.serve", seconds=1.6)
    assert calm["correct"] and slow["correct"]
    assert slow["metrics"]["hop_p95_ms"]["value"] > calm["metrics"]["hop_p95_ms"]["value"] + 50


def test_a_stall_moves_the_bulk_rate(tmp_path, monkeypatch):
    from aec_tpu_torch.pipeline import two_stage

    root = tiny_root(tmp_path)
    _, calm, _ = run_cell(root, "littlenet_kalman.bulk", seconds=1.0)
    # every call stalls for five times what a calm call took: a sixth of the rate
    per_call = 1.0 / calm["attempted"]
    monkeypatch.setattr(two_stage, "two_stage_cancel",
                        stalled(two_stage.two_stage_cancel, 1, 5 * per_call))
    _, slow, _ = run_cell(root, "littlenet_kalman.bulk", seconds=1.0)
    assert slow["metrics"]["xrt"]["value"] < 0.6 * calm["metrics"]["xrt"]["value"]
