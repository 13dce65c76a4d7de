"""K2's share of its roofline: the bound of the window's stage-2 work
(``counts/k2.py``) over the device time of its phases A and C
(``analyse_kernel``, ``synthesise_kernel``) and of phase B on K8
(``gru_kernel``)."""

from aec_bench import peaks
from aec_bench.counts import k2
from aec_bench.trace import seconds_of

KERNELS = ("analyse_kernel", "synthesise_kernel", "gru_kernel")


def read(r):
    s, _ = seconds_of(r["trace"], *KERNELS)
    w = r["work"]
    if s <= 0 or "batches" not in w:
        return None
    flops, nbytes = k2.count(r["cfg"], w["batches"] * w["batch"], w["samples"], w["batches"])
    return 100.0 * peaks.bound_s(flops, nbytes) / s
