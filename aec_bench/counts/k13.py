"""K13, an LSTM layer over many independent rows (``csrc/lstm_rows.cu``):
operations and bytes of its forward (the recurrence, saving the gates) and
its backward, one layer (the input projection and the weight gradients are
products outside the kernel)."""

from __future__ import annotations


def forward(rows: int, frames: int, hidden: int, layers: int, calls: int) -> tuple[float, float]:
    """(flops, bytes): rows T 4H H FMA; xp (4H) in, ys (H) and the saved
    gates and c (5H) out a row-step, W_hh once."""
    fma = rows * frames * 4 * hidden * hidden
    nbytes = 4 * (rows * frames * 10 * hidden + 4 * hidden * hidden)
    return float(2 * fma * layers * calls), float(nbytes * layers * calls)


def backward(rows: int, frames: int, hidden: int, layers: int, calls: int) -> tuple[float, float]:
    """(flops, bytes): rows T 4H H FMA (the forward's product, transposed);
    g_ys (H) and the saved gates and c (5H) in, dxp (4H) out a row-step,
    W_hh once."""
    fma = rows * frames * 4 * hidden * hidden
    nbytes = 4 * (rows * frames * 10 * hidden + 4 * hidden * hidden)
    return float(2 * fma * layers * calls), float(nbytes * layers * calls)
