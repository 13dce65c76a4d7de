"""K9b's (``lstm_bwd_kernel``, ``lstm_bwd_split_kernel``) share of its
roofline: the bound of the window's LSTM backwards (``counts/k9b.py``) over
K9b's device time."""

from aec_bench import peaks
from aec_bench.counts import dccrn, k9b
from aec_bench.trace import seconds_of


def read(r):
    s, _ = seconds_of(r["trace"], "lstm_bwd_kernel", "lstm_bwd_split_kernel")
    w, cfg = r["work"], r["cfg"]
    if s <= 0 or "steps" not in w:
        return None
    sh = dccrn.shapes(cfg, w["samples"])
    flops, nbytes = k9b.count(w["batch"], sh["frames"], sh["hidden"], cfg["net"]["rnn_layers"],
                              w["steps"])
    return 100.0 * peaks.bound_s(flops, nbytes) / s
