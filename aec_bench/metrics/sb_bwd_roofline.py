"""K13's backward (``lstm_rows_bwd_kernel``) share of its roofline: the bound
of the window's sub-band backwards (``counts/k13.py``) over its device time."""

from aec_bench.counts import k13
from aec_bench.metrics.sb_roofline import share


def read(r):
    return share(r, "lstm_rows_bwd_kernel", k13.backward)
