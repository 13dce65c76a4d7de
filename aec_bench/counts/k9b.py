"""K9b, the LSTM backward (``csrc/lstm_bwd.cu``): operations and bytes of one
layer, as ``chip_smoke.py``'s ``k9b_bound`` counts them."""

from __future__ import annotations

from aec_bench.counts.k9 import GROUPS


def count(batch: int, frames: int, hidden: int, layers: int, calls: int) -> tuple[float, float]:
    """(flops, bytes): rows T 4H H FMA (the forward's dots, transposed) over
    rows = G x 2B; g_ys (H), the saved gates and c (5H) in and dxp (4H) out
    a row-step, W_hh once."""
    rows = GROUPS * 2 * batch
    fma = rows * frames * 4 * hidden * hidden
    nbytes = 4 * (rows * frames * 10 * hidden + 4 * hidden * hidden)
    return float(2 * fma * layers * calls), float(nbytes * layers * calls)
