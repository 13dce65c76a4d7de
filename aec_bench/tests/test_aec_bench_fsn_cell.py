"""``fullsubnet.train`` through the harness on the CPU, its widths narrowed
(the program's plain routes against the plain reference): a sound run is
correct, a fault is not, the traced line carries the cell's new metrics;
the new pieces are found by name and the model's count is the
configuration's."""

from __future__ import annotations

import json

from aec_bench.counts import fullsubnet as counts
from aec_bench.tests.helpers import REPO, run_cell, tiny_root

CELL = "fullsubnet.train"
CFG = json.loads((REPO / "aec_bench" / "configs" / "fullsubnet.json").read_text())


def narrow_root(tmp_path):
    """A tiny checkout whose FullSubNet has two layers of 16 and 12 units
    and +-3 bins (257 bins kept: the drop band's 2 x 128 rows a sample)."""
    root = tiny_root(tmp_path)
    cfg_path = root / "aec_bench" / "configs" / "fullsubnet.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["net"].update(fb_model_hidden_size=16, sb_model_hidden_size=12, sb_num_neighbors=3)
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "aec_bench" / "traffic" / "train_fsn.json"
    mix = json.loads(mix_path.read_text())
    mix.update(batch=2, seconds=0.256, pool=4, check_block=96)
    mix_path.write_text(json.dumps(mix))
    return root


def test_sound_run_is_correct_and_traced_line_has_the_metrics(tmp_path):
    root = narrow_root(tmp_path)
    code, line, err = run_cell(root, CELL)
    assert code == 0 and line["correct"], err
    assert set(line["metrics"]) == {"train_xrt", "setup_s"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "step_gap"}
    code, line, err = run_cell(root, CELL, traced=True)
    assert code == 0, err
    got = set(line["metrics"])
    assert {"mfu.fsn_train", "idle_share.fsn_train", "plain_steps.fsn_train",
            "step_host_ms.fsn_train", "bwd_host_ms.fsn_train"} <= got
    assert line["metrics"]["plain_steps.fsn_train"]["value"] == 0.0  # the CPU is not counted


def test_half_batch_fault_is_not_correct(tmp_path):
    """The reference on half of each batch in the program's place."""
    from aec_bench import bench

    import torch

    root = narrow_root(tmp_path)
    ctx, _ = bench.context(root, CELL, 2**31 + 11, torch.device("cpu"))
    limits = bench.read_json(root / "aec_bench" / "checks" / f"{CELL}.json")
    drv = bench.load_module(root, "drivers", ctx.mix["driver"]).Cell(ctx)
    ok, checks = bench.verdict(drv.check(fault="half"), limits)
    assert not ok, checks


def test_model_count_of_the_published_widths():
    """3.90 TFLOP a 16 x 8 s forward (the sub band 3.85 of it), three times
    that a step."""
    fwd = counts.forward_flops(CFG, 16, 128000, 2)
    s = counts.shapes(CFG, 16, 128000, 2)
    assert s["rows"] == 2048 and s["frames"] == 503 and s["sb_input"] == 63
    assert 3.90e12 <= fwd <= 3.91e12
    assert counts.train_step_flops(CFG, 16, 128000, 2) == 3 * fwd


def test_new_readers_read_nothing_where_nothing_ran(monkeypatch):
    """Each new per-layer reader returns None, and raises nothing, on a
    traced window without its kernels, spans or counter (a program that
    lacks what they read, as the parent commit does)."""
    from aec_bench.bench import load_module
    from aec_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "collected", lambda: {"records": [], "summary": {}})
    reading = {"trace": {"kernel_s": {"void other_kernel()": 1.0},
                         "kernel_n": {"void other_kernel()": 3}, "busy_s": 1.0, "window_s": 2.0},
               "cfg": CFG, "mix": {"driver": "train_fsn"},
               "work": {"steps": 3, "batch": 16, "samples": 128000}, "host": {}}
    for name in ("sb_roofline", "sb_bwd_roofline", "fb_ms", "plain_steps", "step_host_ms",
                 "nccl_ms", "allreduce_ms"):
        assert load_module(REPO, "metrics", name).read(reading) is None, name
