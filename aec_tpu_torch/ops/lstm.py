"""LSTM with torch-layout parameters (``aec_tpu/ops/lstm.py``).

Used by DCCRN's bottleneck: a plain LSTM (v1) or a stack of complex LSTMs
(v2). As in ``ops/gru.py`` the input projection of all frames is hoisted into
one matmul; the loop carries only the O(H^2) recurrent work.

Gate math and layout (torch semantics), rows ordered [i; f; g; o]:
    i = sigmoid(x W_ii^T + b_ii + h W_hi^T + b_hi)
    f = sigmoid(...); g = tanh(...); o = sigmoid(...)
    c' = f * c + i * g;   h' = o * tanh(c')
"""

from __future__ import annotations

import math

import torch


def lstm_init(
    input_dim: int, hidden: int, *, generator: torch.Generator | None = None, device="cuda",
) -> dict[str, torch.Tensor]:
    """torch's default init, U(-1/sqrt(H), 1/sqrt(H)) everywhere, drawn on
    the CPU from ``generator`` (one seed, one net on every device), then
    moved to ``device``. JAX draws its own numbers from its key."""
    bound = 1.0 / math.sqrt(hidden)
    shapes = {"w_ih": (4 * hidden, input_dim), "w_hh": (4 * hidden, hidden),
              "b_ih": (4 * hidden,), "b_hh": (4 * hidden,)}
    return {k: torch.empty(s).uniform_(-bound, bound, generator=generator).to(device)
            for k, s in shapes.items()}


def count_plain(x: torch.Tensor, steps: int) -> None:
    """Count ``steps`` frames of a plain recurrence loop (one launch chain a
    frame) run on a CUDA tensor: ``count_plain.steps``, read by
    ``utils/profiling.counters`` as ``lstm.plain_steps``; 0 while every
    recurrence on the card takes its kernel."""
    if x.is_cuda:
        count_plain.steps += steps


count_plain.steps = 0


def quantize_rows_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization, ``w ~= w_q * scale[:, None]``:
    (int8 codes, fp32 per-row scale). Rows of ``w_hh`` are gate-output
    units, so each unit keeps its own grid."""
    amax = torch.amax(torch.abs(w), dim=1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w_q = torch.round(w / scale[:, None]).to(torch.int8)
    return w_q, scale


def lstm_gates(gates: torch.Tensor, c: torch.Tensor, save: bool = False):
    """The pre-activations [i; f; g; o] (..., 4H) and c -> (h', c'); with
    ``save`` also the activated gates and c' (..., 5H) = [i, f, g, o, c'],
    what the backward (``kernels/lstm_bwd.py``) reads. h' and c' are the
    same bits either way."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_next = f * c + i * g
    h = o * torch.tanh(c_next)
    return (h, c_next, torch.cat([i, f, g, o, c_next], dim=-1)) if save else (h, c_next)


def lstm_cell(params: dict[str, torch.Tensor], h: torch.Tensor, c: torch.Tensor,
              x_proj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step given a PRE-PROJECTED input ``x @ w_ih.T + b_ih``: -> (h', c')."""
    return lstm_gates(x_proj + torch.matmul(h, params["w_hh"].T) + params["b_hh"], c)


def lstm_int8_recurrence_plain(
    xp: torch.Tensor, w_q: torch.Tensor, out_scale: torch.Tensor, b_hh: torch.Tensor,
    h0: torch.Tensor, c0: torch.Tensor,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """The int8 recurrence, one step per loop iteration: ``xp`` (B, T, 4H) =
    x W_ih^T + b_ih, ``w_q`` (4H, H) W_hh's per-row int8 codes, ``out_scale``
    (4H,) their row scale / 127 -> (ys (B, T, H), (h_T, c_T)). h is carried
    as int8 at the fixed scale 127; the products sum exactly (in float64,
    which holds 127 * 127 * H exactly for any H a net has). Kernel K10's
    plain version."""
    w_q_t = w_q.T.to(torch.float64)  # (H, 4H) integer codes, exact
    count_plain(xp, xp.shape[1])
    h, c, hs = h0, c0, []
    for i in range(xp.shape[1]):
        h_q = torch.round(torch.clamp(h * 127.0, -127.0, 127.0))
        acc = torch.matmul(h_q.to(torch.float64), w_q_t).to(xp.dtype)
        h, c = lstm_gates(xp[:, i] + acc * out_scale + b_hh, c)
        hs.append(h)
    ys = torch.stack(hs, dim=1) if hs else xp.new_zeros((xp.shape[0], 0, w_q.shape[1]))
    return ys, (h, c)


def _recurrent_dtype(recurrent_dtype):
    """None, "int8" or a float dtype (JAX's spellings: a dtype object or its
    name); any other integer dtype is refused, as JAX refuses it."""
    if recurrent_dtype is None or recurrent_dtype == "int8" or recurrent_dtype is torch.int8:
        return None if recurrent_dtype is None else "int8"
    dt = getattr(torch, recurrent_dtype) if isinstance(recurrent_dtype, str) else recurrent_dtype
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(
            f"integer recurrent_dtype {recurrent_dtype!r} is not supported; only 'int8' "
            "(quantized streaming) is"
        )
    return dt


def lstm_scan(
    params: dict[str, torch.Tensor], x: torch.Tensor, h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None, recurrent_dtype=None, int8_kernel: bool | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """``[B, T, I] -> ([B, T, H], (h_T, c_T))``.

    ``recurrent_dtype`` None is fp32 on every device (JAX picks bf16 only on
    the TPU). A float dtype (``torch.bfloat16``, ``"float16"``, ...) casts
    h and W_hh to it for the recurrent product and sums in fp32, as JAX's
    ``preferred_element_type`` does. ``"int8"`` (inference only) quantizes
    W_hh per row, carries h as int8 at the fixed scale 127 and sums the
    products exactly (in float64, which holds 127 * 127 * H exactly for any H
    a net has), dequantizing with one (B, 4H) multiply.

    The int8 branch routes by ``int8_kernel``: None runs kernel K10
    (``kernels/lstm_int8.py``) on a CUDA tensor, from any initial state, B
    and H, with W_hh's codes and their on-chip layout built once per weight
    tensor and cached (``lstm_int8.quantized``), and the plain loop
    (:func:`lstm_int8_recurrence_plain`, K10's plain version, quantizing
    every call) on a CPU tensor; True keeps the refusals of JAX's
    int8-resident kernel (``pallas_lstm.lstm_int8_fused``: zero initial
    state, H % 128 == 0), then routes as None does; False is the plain loop
    on any device. A CUDA call that K10 cannot take raises. JAX's TPU int8
    route is its XLA scan, not its kernel (``aec_tpu/ops/lstm.py:129-147``);
    the port's alternative to K10 is a chain of launches per step, so a CUDA
    tensor takes the kernel.
    """
    b, t, _ = x.shape
    hidden = params["w_hh"].shape[-1]
    default_state = h0 is None and c0 is None
    if h0 is None:
        h0 = x.new_zeros((b, hidden))
    if c0 is None:
        c0 = x.new_zeros((b, hidden))
    x_proj = torch.matmul(x, params["w_ih"].T) + params["b_ih"]
    rdt = _recurrent_dtype(recurrent_dtype)
    b_hh = params["b_hh"]

    if rdt == "int8":
        if int8_kernel and not (default_state and hidden % 128 == 0):
            raise ValueError(
                "int8_kernel=True needs zero initial state and 128-aligned hidden dim "
                f"(got h0/c0 set or hidden={hidden})"
            )
        if x.is_cuda and int8_kernel is not False:
            from aec_tpu_torch.kernels.lstm_int8 import lstm_int8_recurrence, quantized

            w_q, out_scale = quantized(params["w_hh"])
            return lstm_int8_recurrence(x_proj, w_q, out_scale, b_hh, h0, c0)
        w_q, w_scale = quantize_rows_int8(params["w_hh"])
        out_scale = (w_scale / 127.0).to(x.dtype)
        return lstm_int8_recurrence_plain(x_proj, w_q, out_scale, b_hh, h0, c0)
    if rdt is not None:
        w_hh_t = params["w_hh"].T.to(rdt).to(x.dtype)  # cast ONCE

        def step(h, c, xp_t):
            return lstm_gates(xp_t + torch.matmul(h.to(rdt).to(x.dtype), w_hh_t) + b_hh, c)
    else:

        def step(h, c, xp_t):
            return lstm_cell(params, h, c, xp_t)

    count_plain(x, t)
    h, c, hs = h0, c0, []
    for i in range(t):
        h, c = step(h, c, x_proj[:, i])
        hs.append(h)
    ys = torch.stack(hs, dim=1) if hs else x.new_zeros((b, 0, hidden))
    return ys, (h, c)


def complex_lstm_init(
    input_dim: int, hidden: int, *, generator: torch.Generator | None = None, device="cuda",
) -> dict[str, dict[str, torch.Tensor]]:
    """'Naive' complex LSTM: separate real/imag LSTMs of half width,
    cross-combined as (r2r - i2i, i2r + r2i)."""
    return {g: lstm_init(input_dim // 2, hidden // 2, generator=generator, device=device)
            for g in ("real", "imag")}


GROUPS = ("real", "imag")


def stacked(params: dict, key: str) -> torch.Tensor:
    """One parameter of both groups stacked: (2, ...)."""
    return torch.stack([params[g][key] for g in GROUPS])


def grouped_projection(params: dict, x2: torch.Tensor) -> torch.Tensor:
    """The hoisted input projection of both groups with both biases:
    ``x2`` (2B, T, I) -> xp (2, 2B, T, 4H)."""
    w_ih = stacked(params, "w_ih")
    bias = stacked(params, "b_ih") + stacked(params, "b_hh")
    xp = torch.matmul(x2.unsqueeze(0), w_ih.transpose(1, 2).unsqueeze(1))
    return xp + bias[:, None, None, :]


def grouped_lstm_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor, save: bool = False):
    """The grouped recurrence, one step per loop iteration: xp (G, R, T, 4H)
    and w_hh (G, 4H, H) -> ys (G, R, T, H), from zero state; with ``save``
    also each step's activated gates and c (G, R, T, 5H), what K9 saves for
    its backward K9b. It is kernel K9's plain version (``kernels/lstm.py``)."""
    g, r, t, h4 = xp.shape
    hidden = h4 // 4
    h = xp.new_zeros((g, r, hidden))
    c = xp.new_zeros((g, r, hidden))
    w_t = w_hh.transpose(1, 2)
    count_plain(xp, t)
    hs, saved = [], []
    for i in range(t):
        h, c, *act = lstm_gates(xp[:, :, i] + torch.matmul(h, w_t), c, save)
        hs.append(h)
        saved += act
    ys = torch.stack(hs, dim=2) if hs else xp.new_zeros((g, r, 0, hidden))
    if not save:
        return ys
    return ys, torch.stack(saved, dim=2) if saved else xp.new_zeros((g, r, 0, 5 * hidden))


def recombine(ys: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ys (2, 2B, T, H) -> (r2r - i2i, i2r + r2i)."""
    r2r, i2r = ys[0, :b], ys[0, b:]
    r2i, i2i = ys[1, :b], ys[1, b:]
    return r2r - i2i, i2r + r2i


def complex_lstm_scan(
    params: dict, real: torch.Tensor, imag: torch.Tensor, fused: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``([B, T, I/2], [B, T, I/2]) -> ([B, T, H/2], [B, T, H/2])``.

    The four naive-complex LSTM passes (real/imag parameters x real/imag
    inputs) share the time axis, so they fold into one loop whose step is a
    single grouped product: the group axis stacks the two parameter sets,
    the batch axis the two inputs. The input projection with both biases is
    hoisted out of the loop (:func:`grouped_projection`), as JAX's kernel
    hoists it.

    ``fused`` routes as JAX routes on its TPU: None takes the fused route
    (kernel K9, ``kernels/lstm.py``, differentiable) on a CUDA tensor at
    B <= 16 and T >= 64, the plain grouped loop otherwise. An explicit
    ``fused=True`` on a CPU tensor runs the fused route's autograd Function
    over the kernel's plain version (JAX runs its kernel in interpret mode
    there); ``fused=False`` is the plain loop.
    """
    b, t, _ = real.shape
    if fused is None:
        fused = b <= 16 and t >= 64 and real.is_cuda
    if fused:
        from aec_tpu_torch.kernels.lstm import complex_lstm_scan_fused

        return complex_lstm_scan_fused(params, real, imag)
    xp = grouped_projection(params, torch.cat([real, imag], dim=0))
    return recombine(grouped_lstm_recurrence_plain(xp, stacked(params, "w_hh")), b)
