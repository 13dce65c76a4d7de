"""GRU recurrence with torch-layout parameters (``aec_tpu/ops/gru.py``).

Parameters are stacked gates ordered [reset; update; new] with separate
input/hidden biases — the ``torch.nn.GRU`` layout. The input projection for
all frames is hoisted out of the recurrence into one matmul; the loop only
carries the hidden-state work.

    r  = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z  = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n  = tanh(x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h
"""

from __future__ import annotations

import torch


def gru_cell(params: dict[str, torch.Tensor], h: torch.Tensor,
             x_proj: torch.Tensor) -> torch.Tensor:
    """One GRU step given a PRE-PROJECTED input ``x @ w_ih.T + b_ih``
    [B, 3H]; ``h`` is [B, H]. Returns h' [B, H]."""
    h_proj = torch.matmul(h, params["w_hh"].T) + params["b_hh"]  # [B, 3H]
    xr, xz, xn = torch.chunk(x_proj, 3, dim=-1)
    hr, hz, hn = torch.chunk(h_proj, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_scan(
    params: dict[str, torch.Tensor], x: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the GRU over frames: ``[B, T, I] -> ([B, T, H], h_T)``."""
    b, t, _ = x.shape
    hidden = params["w_hh"].shape[-1]
    h = x.new_zeros((b, hidden)) if h0 is None else h0
    x_proj = torch.matmul(x, params["w_ih"].T) + params["b_ih"]  # [B, T, 3H]
    ys = x.new_empty((b, t, hidden))
    for i in range(t):
        h = gru_cell(params, h, x_proj[:, i])
        ys[:, i] = h
    return ys, h
