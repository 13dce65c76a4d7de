"""The counts against the bounds PERF.md states, and DCCRN's model count
against ``torch.utils.flop_counter`` on the plain reference."""

from __future__ import annotations

import copy
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from aec_bench.counts import dccrn, k1, k2, k3
from aec_bench.reference import dccrn as ref_dccrn
from aec_bench.tests.helpers import REPO

LN = json.loads((REPO / "aec_bench" / "configs" / "littlenet_kalman.json").read_text())
DC = json.loads((REPO / "aec_bench" / "configs" / "dccrn.json").read_text())


def test_kernel_counts_are_perfs_bounds():
    assert k1.step_flops(256, 10) == 351_618  # the FFT step
    assert k2.frame_flops(LN) == 65_338  # K2's FFT formulation a frame
    assert k3.hop_flops(LN) == 416_956  # a K3 / K4 hop


def test_dccrn_count_is_the_flop_counters():
    """The counter sees every conv, transposed conv and product of the plain
    reference's forward; its FFTs and elementwise work are left out by both."""
    cfg = copy.deepcopy(DC)
    cfg["net"]["conv_channels"] = [4, 8, 16]
    n = 256 * 12
    p, s = ref_dccrn.make_weights(cfg, 1, "cpu")
    x = torch.randn(2, n)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref_dccrn.forward(p, s, x, x, train=False)
    assert fc.get_total_flops() == dccrn.forward_flops(cfg, 2, n)


def test_dccrn_full_width_parameters():
    p, _ = ref_dccrn.make_weights(DC, 1, "cpu")
    total = sum(v.numel() for _, v in ref_dccrn.leaves(p))
    h = dccrn.shapes(DC, 16000)["hidden"]
    assert h == 1024
    assert total > 2 * 2 * 2 * 4 * h * h  # the LSTMs hold nearly all of it
