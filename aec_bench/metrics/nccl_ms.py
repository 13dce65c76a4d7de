"""Rank 0's collectives on the card a step: the device ms of its NCCL
kernels (the gradient sum and the BatchNorms' all-reduces, forward and
backward) over the window's steps."""

from aec_bench.trace import seconds_of


def read(r):
    s, n = seconds_of(r["trace"], "nccl")
    w = r["work"]
    if n == 0 or "steps" not in w:
        return None
    return 1e3 * s / w["steps"]
