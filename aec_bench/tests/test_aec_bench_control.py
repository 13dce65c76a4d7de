"""On the card: the control (the plain reference in TF32, the precision below
the configurations' float32, put in the program's place) comes out not
correct in every cell, on three seeds, at sizes a test run holds; the program
itself comes out correct on the same inputs. Run on a machine with a card:
``python -m pytest aec_bench/tests/test_aec_bench_control.py``."""

from __future__ import annotations

import gc
import json

import pytest
import torch

from aec_bench import bench
from aec_bench.tests.helpers import tiny_root
from aec_bench.trace import Window

CELLS = ["littlenet_kalman.bulk", "dccrn.train", "littlenet_kalman.serve", "dccrn.infer"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("control"))
    # K8 and K9 take the kernel route from 64 frames; the serving tick at
    # enough streams to fill the card's first wave
    for mix, extra in (("bulk", {"seconds": 2.048}), ("train", {"seconds": 2.048}),
                       ("infer", {"seconds": 2.048}), ("serve", {"streams": 264})):
        p = root / "aec_bench" / "traffic" / f"{mix}.json"
        p.write_text(json.dumps(dict(json.loads(p.read_text()), **extra)))
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [101, 2**31 + 7, 2**40 + 9])
def test_control_is_not_correct(root, cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the card computes")
    ctx, _ = bench.context(root, cell, seed, torch.device("cuda", 0))
    bench.set_precision(ctx.cfg)
    limits = bench.read_json(root / "aec_bench" / "checks" / f"{cell}.json")
    drv = bench.load_module(root, "drivers", ctx.mix["driver"]).Cell(ctx)
    with Window(False) as win:
        drv.window(0.5, win)
    drv.release()
    ok, checks = bench.verdict(drv.check(), limits)
    assert ok, checks
    ok, checks = bench.verdict(drv.check(control=True), limits)
    assert not ok, checks
    del drv
    gc.collect()
    torch.cuda.empty_cache()
