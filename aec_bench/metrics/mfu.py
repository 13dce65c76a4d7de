"""The whole step's share of the card's fp32 peak: the configuration's model
flops for the window's work (``counts/<config>.py``, a fixed count whatever
implements it) over the traced window."""

import importlib

from aec_bench import peaks


def read(r):
    counts = importlib.import_module(f"aec_bench.counts.{r['cfg']['name']}")
    flops = counts.work_flops(r["cfg"], r["mix"], r["work"])
    return 100.0 * flops / r["trace"]["window_s"] / peaks.PEAK_FP32
