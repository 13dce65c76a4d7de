"""The full band's recurrences a step: the device ms of K9 (``lstm_kernel``)
and K9b (``lstm_bwd_kernel``, ``lstm_bwd_split_kernel``), which carry its two
layers of 16 rows forward and backward (its products are cuBLAS's, unnamed
by band, and left out)."""

from aec_bench.trace import seconds_of


def read(r):
    s, n = seconds_of(r["trace"], "lstm_kernel", "lstm_bwd_kernel", "lstm_bwd_split_kernel")
    w = r["work"]
    if n == 0 or "steps" not in w:
        return None
    return 1e3 * s / w["steps"]
