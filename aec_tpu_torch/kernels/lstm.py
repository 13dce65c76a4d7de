"""Kernel K9: DCCRN's grouped complex-LSTM recurrence as one CUDA launch, differentiable.

Replaces ``aec_tpu/kernels/pallas_lstm.py:88`` (``_grouped_lstm_fused_fwd``,
``pallas_call`` at ``:123``) and its custom VJP ``complex_lstm_scan_fused``
(``:160-184``, backward ``:341-350``). The kernel is ``csrc/lstm.cu`` on
``csrc/grid_scan.cuh``: one persistent grid of co-resident CTAs, each owning
a few (group, hidden unit) pairs and their four gate columns of W_hh^T (read
from L2 every step), one grid barrier per step (the source's header has the
reckoning).

As in JAX, the input projections of the four naive-complex paths and both
biases are one matmul outside the kernel (:func:`grouped_projection`): two
parameter groups (real, imag), each over 2B rows (the real and the imaginary
inputs). The kernel carries the recurrence from zero state, and the outputs
recombine as ``(r2r - i2i, i2r + r2i)``. Everything stays fp32 (JAX's TPU
kernel rounds h and W to bf16).

:class:`ComplexLstmScanFused` does what the JAX custom VJP does: the forward
through K9 (its plain version on the CPU), the backward by recomputing the
plain grouped scan (``ops.lstm.complex_lstm_scan(fused=False)``) and
differentiating it. JAX has no backward kernel, so neither has the port.
:func:`grouped_lstm_recurrence` is the kernel's wrapper (a CUDA tensor
launches K9 or raises, a CPU tensor takes the plain recurrence).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.gru import pack_gate_columns
from aec_tpu_torch.ops.lstm import (
    GROUPS,
    complex_lstm_scan,
    grouped_lstm_recurrence_plain,
    grouped_projection,
    recombine,
    stacked,
)

_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_lstm.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.aec_lstm.restype = ctypes.c_int
    lib.aec_lstm_units.argtypes = [i, i, i, i]
    lib.aec_lstm_units.restype = ctypes.c_int
    lib.aec_lstm_smem.argtypes = [i, i, i]
    lib.aec_lstm_smem.restype = ctypes.c_longlong
    return lib


def _check(xp: torch.Tensor, w_hh: torch.Tensor) -> None:
    if xp.device.type != "cuda" or w_hh.device != xp.device:
        raise ValueError(f"xp and w_hh must be on one CUDA device, got {xp.device}, {w_hh.device}")
    if xp.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"xp and w_hh must be float32, got {xp.dtype}, {w_hh.dtype}")
    if xp.ndim != 4 or w_hh.ndim != 3:
        raise ValueError(f"want xp (G, R, T, 4H) and w_hh (G, 4H, H), got {tuple(xp.shape)}, "
                         f"{tuple(w_hh.shape)}")
    g, _, steps, h4 = xp.shape
    hidden = w_hh.shape[-1]
    if h4 != 4 * hidden or tuple(w_hh.shape) != (g, h4, hidden) or steps < 1:
        raise ValueError(f"want xp (G, R, T >= 1, 4H) and w_hh (G, 4H, H), got "
                         f"{tuple(xp.shape)}, {tuple(w_hh.shape)}")
    if not xp.is_contiguous():
        raise ValueError("xp must be contiguous")


def grouped_lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The grouped LSTM recurrence over the hoisted projection ``xp``
    (G, R, T, 4H) (:func:`grouped_projection`) with ``w_hh`` (G, 4H, H) ->
    ys (G, R, T, H), from zero state.

    A CUDA tensor launches K9 (or raises: not fp32, not contiguous, T = 0, a
    group's h that one CTA's shared memory cannot hold, a grid the card
    cannot hold co-resident); a CPU tensor takes the plain recurrence.
    """
    if xp.device.type == "cpu":
        return grouped_lstm_recurrence_plain(xp, w_hh)
    _check(xp, w_hh)
    lib = _lib()
    g, r, t, h4 = xp.shape
    hidden, dev = h4 // 4, xp.device.index
    units = lib.aec_lstm_units(g, r, hidden, dev)
    _build.check_smem(lib.aec_lstm_smem(r, hidden, units), xp.device,
                      "the grouped LSTM kernel (a group's h in every CTA)")
    wp = pack_gate_columns(w_hh.detach(), 4, units)  # held until the launch is enqueued
    hbuf = xp.new_zeros((2, g, r, hidden))
    ys = xp.new_empty((g, r, t, hidden))
    err = lib.aec_lstm(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(hbuf), _build.ptr(ys),
        g, r, t, hidden, units, dev, _build.stream_of(xp),
    )
    _build.check(err, "lstm")
    grouped_lstm_recurrence.launches += 1
    return ys


grouped_lstm_recurrence.launches = 0


def _params(flat) -> dict:
    """The 8 tensors in (real, imag) x (w_ih, w_hh, b_ih, b_hh) order -> the
    complex-LSTM params dict."""
    return {g: dict(zip(_KEYS, flat[4 * j: 4 * j + 4])) for j, g in enumerate(GROUPS)}


def _flat(params: dict) -> list[torch.Tensor]:
    return [params[g][k] for g in GROUPS for k in _KEYS]


class ComplexLstmScanFused(torch.autograd.Function):
    """``(real, imag, *the 8 parameters) -> (real_out, imag_out)``: forward
    through K9 (plain on the CPU), backward by recomputing the plain grouped
    scan."""

    @staticmethod
    def forward(ctx, real, imag, *weights):
        params = _params(weights)
        xp = grouped_projection(params, torch.cat([real, imag], dim=0))
        ys = grouped_lstm_recurrence(xp.contiguous(), stacked(params, "w_hh"))
        ctx.save_for_backward(real, imag, *weights)
        return recombine(ys, real.shape[0])

    @staticmethod
    def backward(ctx, g_real, g_imag):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = complex_lstm_scan(_params(leaves[2:]), leaves[0], leaves[1], fused=False)
            cot = [torch.zeros_like(o) if gr is None else gr
                   for o, gr in zip(out, (g_real, g_imag))]
            need = [t for t, n in zip(leaves, ctx.needs_input_grad) if n]
            grads = iter(torch.autograd.grad(out, need, cot))
        return tuple(next(grads) if n else None for n in ctx.needs_input_grad)


def complex_lstm_scan_fused(params: dict, real: torch.Tensor,
                            imag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused grouped complex LSTM: ``([B, T, I], [B, T, I]) -> ([B, T, H],
    [B, T, H])``, differentiable in both inputs and the 8 parameters."""
    return ComplexLstmScanFused.apply(real, imag, *_flat(params))


def complex_lstm_scan_fused_plain(params: dict, real: torch.Tensor,
                                  imag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`complex_lstm_scan_fused`'s forward: the plain
    grouped scan, ``complex_lstm_scan(fused=False)`` (the hoisted projection,
    K9's arithmetic in torch, the recombination)."""
    return complex_lstm_scan(params, real, imag, fused=False)
