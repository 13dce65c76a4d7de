"""Kernel K10: the int8 LSTM recurrence as one CUDA launch (inference only).

Replaces ``aec_tpu/kernels/pallas_lstm.py:237`` (``lstm_int8_fused``,
``pallas_call`` at ``:299``). The kernel is ``csrc/lstm_int8.cu``: one
persistent grid of co-resident CTAs, each owning a few hidden units and
streaming their 4 gate rows of W_hh's int8 codes from device memory every
step into ``__dp4a`` dots against h's codes, one grid barrier per step (the
source's header has the reckoning). It repeats the plain loop's arithmetic
operation for operation (``ops.lstm.lstm_int8_recurrence_plain``), so the
two agree to the last bit unless a transcendental differs by an ulp.

Unlike JAX's kernel it takes any initial state, any B and any H: the wrapper
pads each row of codes to a multiple of 16 with zeros and writes h0's codes
into the first ping-pong buffer. The rounding sites have no gradient, so
there is no autograd Function (JAX's kernel has no VJP either).
:func:`lstm_int8_recurrence` is the kernel's wrapper (a CUDA tensor launches
K10 or raises, a CPU tensor takes the plain loop).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.ops.lstm import lstm_int8_recurrence_plain


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_lstm_int8.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.aec_lstm_int8.restype = ctypes.c_int
    lib.aec_lstm_int8_smem.argtypes = [i, i, i, i]
    lib.aec_lstm_int8_smem.restype = ctypes.c_longlong
    return lib


def _check(xp, w_q, out_scale, b_hh, h0, c0) -> None:
    tensors = (xp, w_q, out_scale, b_hh, h0, c0)
    if xp.device.type != "cuda" or any(a.device != xp.device for a in tensors):
        raise ValueError(f"xp, w_q, out_scale, b_hh, h0 and c0 must be on one CUDA device, got "
                         f"{[str(a.device) for a in tensors]}")
    if w_q.dtype != torch.int8 or any(a.dtype != torch.float32 for a in tensors if a is not w_q):
        raise TypeError(f"want w_q int8 and the rest float32, got {[a.dtype for a in tensors]}")
    if xp.ndim != 3 or w_q.ndim != 2:
        raise ValueError(f"want xp (B, T, 4H) and w_q (4H, H), got {tuple(xp.shape)}, "
                         f"{tuple(w_q.shape)}")
    b, _, h4 = xp.shape
    hidden = w_q.shape[1]
    if (h4 != 4 * hidden or hidden < 1 or b < 1 or tuple(w_q.shape) != (h4, hidden)
            or tuple(out_scale.shape) != (h4,) or tuple(b_hh.shape) != (h4,)
            or tuple(h0.shape) != (b, hidden) or tuple(c0.shape) != (b, hidden)):
        raise ValueError(
            f"want xp (B, T, 4H), w_q (4H, H), out_scale and b_hh (4H,), h0 and c0 (B, H) with "
            f"B, H >= 1, got {[tuple(a.shape) for a in tensors]}")
    if not all(a.is_contiguous() for a in (xp, out_scale, b_hh, c0)):
        raise ValueError("xp, out_scale, b_hh and c0 must be contiguous")


def lstm_int8_recurrence(
    xp: torch.Tensor, w_q: torch.Tensor, out_scale: torch.Tensor, b_hh: torch.Tensor,
    h0: torch.Tensor, c0: torch.Tensor,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """The int8 recurrence over ``xp`` (B, T, 4H) = x W_ih^T + b_ih with
    W_hh's per-row codes ``w_q`` (4H, H) int8, their ``out_scale`` (4H,) =
    row scale / 127, ``b_hh`` (4H,) and the initial state ``h0``, ``c0``
    (B, H) -> (ys (B, T, H), (h_T, c_T)).

    A CUDA tensor launches K10 (T = 0 launches nothing), or raises: another
    dtype, a strided input, a B whose codes of h one CTA's shared memory
    cannot hold, a grid the card cannot hold co-resident. A CPU tensor takes
    the plain loop.
    """
    if xp.device.type == "cpu":
        return lstm_int8_recurrence_plain(xp, w_q, out_scale, b_hh, h0, c0)
    _check(xp, w_q, out_scale, b_hh, h0, c0)
    b, t, h4 = xp.shape
    hidden, dev = h4 // 4, xp.device.index
    if t == 0:
        return xp.new_zeros((b, 0, hidden)), (h0, c0)
    lib = _lib()
    hp = -(-hidden // 16) * 16
    _build.check_smem(lib.aec_lstm_int8_smem(b, hidden, hp, dev), xp.device,
                      "the int8 LSTM kernel (the codes of h for every row in every CTA)")
    wq = w_q.new_zeros((h4, hp))  # each row padded with zero codes; held until enqueued
    wq[:, :hidden] = w_q
    hq = w_q.new_zeros((2, b, hp))
    hq[0, :, :hidden] = torch.round(torch.clamp(h0 * 127.0, -127.0, 127.0)).to(torch.int8)
    ys = xp.new_empty((b, t, hidden))
    c_t = xp.new_empty((b, hidden))
    err = lib.aec_lstm_int8(
        _build.ptr(xp), _build.ptr(wq), _build.ptr(out_scale), _build.ptr(b_hh), _build.ptr(c0),
        _build.ptr(hq), _build.ptr(ys), _build.ptr(c_t), b, t, hidden, hp, dev,
        _build.stream_of(xp),
    )
    _build.check(err, "lstm_int8")
    lstm_int8_recurrence.launches += 1
    return ys, (ys[:, -1], c_t)


lstm_int8_recurrence.launches = 0
