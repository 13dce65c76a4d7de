"""K3's (``serving_kernel``) share of its roofline: the bound of the window's
hops (``counts/k3.py``) over K3's device time."""

from aec_bench import peaks
from aec_bench.counts import k3
from aec_bench.trace import seconds_of


def read(r):
    s, _ = seconds_of(r["trace"], "serving_kernel")
    w = r["work"]
    if s <= 0 or "ticks" not in w:
        return None
    flops, nbytes = k3.count(r["cfg"], w["ticks"], w["streams"])
    return 100.0 * peaks.bound_s(flops, nbytes) / s
