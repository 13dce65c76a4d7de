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

import math
from typing import TypedDict

import torch

from aec_tpu_torch.kernels.gru import MAX_HIDDEN, wide_fits


class GruParams(TypedDict):
    """The parameter dict of :func:`gru_init`, keyed as JAX's."""

    w_ih: torch.Tensor  # (3H, I)
    w_hh: torch.Tensor  # (3H, H)
    b_ih: torch.Tensor  # (3H,)
    b_hh: torch.Tensor  # (3H,)


def gru_init(
    input_dim: int, hidden: int, *, orthogonal: bool = True,
    generator: torch.Generator | None = None, device="cuda",
) -> dict[str, torch.Tensor]:
    """GRU parameters drawn on the CPU from ``generator`` (so one seed gives
    one net on every device), then moved to ``device``.

    ``orthogonal=True`` is the reference's init policy: orthogonal weight
    matrices; biases keep torch's default U(-1/sqrt(H), 1/sqrt(H)).
    ``orthogonal=False`` draws the weights from that uniform too.
    """
    bound = 1.0 / math.sqrt(hidden)
    w_ih, w_hh = torch.empty(3 * hidden, input_dim), torch.empty(3 * hidden, hidden)
    for w in (w_ih, w_hh):
        if orthogonal:
            torch.nn.init.orthogonal_(w, generator=generator)
        else:
            w.uniform_(-bound, bound, generator=generator)
    b_ih = torch.empty(3 * hidden).uniform_(-bound, bound, generator=generator)
    b_hh = torch.empty(3 * hidden).uniform_(-bound, bound, generator=generator)
    params = {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
    return {k: v.to(device) for k, v in params.items()}


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


def kernel_route(b: int, t: int, hidden: int, device_type: str) -> bool:
    """Whether ``gru_scan(fused=None)`` takes the fused route (K8, and K8b
    in the backward): a CUDA tensor with ``T >= 64`` at any B where K8 holds
    W_hh in registers (H <= 128), and above that wherever the wide path's
    plan holds both K8 and K8b (``kernels.gru.wide_fits``, a pure function
    of B and H: the DCT-CNN's H = 512 to B = 36).

    JAX routes its kernel at ``B == 1`` only (``aec_tpu/ops/gru.py:108``),
    because on a TPU v5e at batch 256 x 513 frames XLA's compiled
    ``lax.scan`` beat the Pallas kernel (0.53 ms against 1.49). The port has
    no compiled loop to fall back on: its plain route is an eager loop of
    ~6 launches a frame forward and ~10 backward, hundreds of ms at a
    training batch, so it routes wider, at every width its kernels hold. On
    an H100 80GB HBM3 at 700 W, H = 32 (``chip_smoke.py`` phase 16): before
    the route took B > 1, at B = 8 x 501 frames K8's recurrence took
    0.228-0.271 ms, its whole forward 0.341-0.498, cuDNN's ``nn.GRU``
    0.329-0.424 and the plain loop users got 77.8-111.7; at B = 16
    0.210-0.283, 0.309-0.534, 0.289-0.461 and 64.2-116.0. With the route (two
    runs, medians of four turns): at B = 8 the forward 0.330-0.489 ms
    against cuDNN's 0.356-0.488, the forward and backward (K8 + K8b)
    1.70-1.75 against cuDNN's 1.71-2.04 and the plain loop's 364-415; at B
    = 16 0.329-0.465 against 0.354-0.484, and 1.27-1.69 against 1.51-1.99
    and 354-400. ``PERF.md`` has the wide path's numbers.
    """
    return device_type == "cuda" and t >= 64 and (hidden <= MAX_HIDDEN or wide_fits(b, hidden))


def gru_scan(
    params: dict[str, torch.Tensor], x: torch.Tensor,
    h0: torch.Tensor | None = None, *, fused: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the GRU over frames: ``[B, T, I] -> ([B, T, H], h_T)``.

    ``fused=None`` routes by :func:`kernel_route`: the fused route (kernel
    K8 forward and K8b backward, ``kernels/gru.py``) on a CUDA tensor at T
    >= 64 wherever the kernels' plans hold the shape (any B to H = 128, the
    wide path above), the plain loop otherwise. An
    explicit ``fused=True`` on a CPU tensor runs the fused route's autograd
    Function over the kernels' plain versions (JAX runs its kernel in
    interpret mode there); ``fused=False`` is the plain loop.
    """
    b, t, _ = x.shape
    hidden = params["w_hh"].shape[-1]
    if h0 is None:
        h0 = x.new_zeros((b, hidden))
    if fused is None:
        fused = kernel_route(b, t, hidden, x.device.type)
    if fused:
        from aec_tpu_torch.kernels.gru import gru_scan_fused

        return gru_scan_fused(params, x, h0)
    x_proj = torch.matmul(x, params["w_ih"].T) + params["b_ih"]  # [B, T, 3H]
    h, hs = h0, []
    for i in range(t):
        h = gru_cell(params, h, x_proj[:, i])
        hs.append(h)
    # one stack, not T slice writes: autograd then holds one node, not T
    ys = torch.stack(hs, dim=1) if hs else x.new_zeros((b, 0, hidden))
    return ys, h
