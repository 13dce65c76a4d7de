"""K1's (``kalman_batched_kernel``) share of its roofline: the bound of the
window's stage-1 work (``counts/k1.py``) over K1's device time."""

from aec_bench import peaks
from aec_bench.counts import k1
from aec_bench.trace import seconds_of


def utterances(work):
    return work["batches"] * work["batch"] if "batches" in work else work["utterances"]


def read(r):
    s, _ = seconds_of(r["trace"], "kalman_batched_kernel")
    if s <= 0:
        return None
    flops, nbytes = k1.count(r["cfg"], utterances(r["work"]), r["work"]["samples"])
    return 100.0 * peaks.bound_s(flops, nbytes) / s
