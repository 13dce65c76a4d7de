"""K9, the grouped complex-LSTM recurrence (``csrc/lstm.cu``): operations and
bytes of one layer, as ``chip_smoke.py``'s K9 bound counts them (the input
projection is a separate product and is not K9's)."""

from __future__ import annotations

GROUPS = 2  # the "real" and "imag" LSTMs, each over both parts as rows


def count(batch: int, frames: int, hidden: int, layers: int, calls: int,
          saving: bool) -> tuple[float, float]:
    """(flops, bytes) of ``calls`` forwards of ``layers`` layers at ``batch``
    x ``frames``: 2 G B T 4H H FMA a layer; xp in, W_hh once, ys out, and
    with ``saving`` the activated gates and c (5H a row-step) out."""
    rows = 2 * batch
    fma = GROUPS * rows * frames * 4 * hidden * hidden
    per_row_step = 4 * hidden + hidden + (5 * hidden if saving else 0)
    nbytes = 4 * (GROUPS * rows * frames * per_row_step + GROUPS * 4 * hidden * hidden)
    return float(2 * fma * layers * calls), float(nbytes * layers * calls)
