"""K9's (``lstm_kernel``) share of its roofline: the bound of the window's
complex-LSTM recurrences (``counts/k9.py``; two layers a forward, saving the
gates in training) over K9's device time."""

from aec_bench import peaks
from aec_bench.counts import dccrn, k9
from aec_bench.trace import seconds_of


def read(r):
    s, _ = seconds_of(r["trace"], "lstm_kernel")
    if s <= 0:
        return None
    w, cfg = r["work"], r["cfg"]
    sh = dccrn.shapes(cfg, w["samples"])
    training = "steps" in w
    batch, calls = (w["batch"], w["steps"]) if training else (1, w["utterances"])
    flops, nbytes = k9.count(batch, sh["frames"], sh["hidden"], cfg["net"]["rnn_layers"], calls,
                             saving=training)
    return 100.0 * peaks.bound_s(flops, nbytes) / s
