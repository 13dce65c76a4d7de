"""K13's forward (``lstm_rows_kernel``) share of its roofline: the bound of
the window's sub-band recurrences (``counts/k13.py``; both layers a step,
saving the gates, on drop band's rows) over its device time."""

from aec_bench import peaks
from aec_bench.counts import fullsubnet, k13
from aec_bench.trace import seconds_of

KERNEL = "lstm_rows_kernel"


def count(r, which):
    """(flops, bytes) of the window's sub band on K13, ``which`` the
    forward's or the backward's count."""
    w, cfg = r["work"], r["cfg"]
    s = fullsubnet.shapes(cfg, w["batch"], w["samples"], cfg["net"]["num_groups_in_drop_band"])
    return which(s["rows"], s["frames"], s["sb_hidden"], s["layers"], w["steps"])


def share(r, kernel, which):
    s, _ = seconds_of(r["trace"], kernel)
    if s <= 0 or "steps" not in r["work"]:
        return None
    return 100.0 * peaks.bound_s(*count(r, which)) / s


def read(r):
    return share(r, KERNEL, k13.forward)
