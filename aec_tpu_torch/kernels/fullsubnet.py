"""Kernel K11: FullSubNet's joint full/sub-band LSTM recurrence in one CUDA launch, differentiable.

Replaces ``aec_tpu/kernels/pallas_fullsubnet.py:106`` (``_fsn_joint_fused_fwd``,
``pallas_call`` at ``:154``) and its custom VJP ``fsn_joint_fused``
(``:188-217``). The kernel is ``csrc/fullsubnet.cu``: one persistent grid of
co-resident CTAs, the sub-band rows and the full-band units split over it,
the sub-band W_hh in every CTA's shared memory, one grid barrier per frame
(the source's header has the reckoning). Everything stays fp32 (JAX's TPU
kernel rounds the dots' operands to bf16). JAX's kernel takes one utterance;
this one takes B >= 1.

The hoisted input projections with every bias (in
``models.fullsubnet.fullsubnet_masks``) and the mask head stay outside, as
in JAX.
:class:`FsnJointFused` does what the JAX custom VJP does: the forward
through K11 (its plain version on the CPU), the backward by recomputing the
plain joint loop ``models.fullsubnet._joint_scan_hs`` and differentiating
it; JAX has no backward kernel, so neither has the port.
:func:`joint_recurrence` is the kernel's wrapper (a CUDA tensor launches K11
or raises, a CPU tensor takes the plain loop).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aec_tpu_torch.kernels import _build

_LEAVES = (("fb_lstm", "w_hh"), ("fb_out", "w"), ("fb_out", "b"), ("sb_lstm", "w_ih"),
           ("sb_lstm", "w_hh"))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fullsubnet")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_fsn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.aec_fsn.restype = ctypes.c_int
    lib.aec_fsn_smem.argtypes = [i, i, i, i, i]
    lib.aec_fsn_smem.restype = ctypes.c_longlong
    return lib


def _params(flat) -> dict:
    """The leaves in ``_LEAVES`` order -> the part of the param tree the
    joint recurrence reads."""
    tree: dict = {}
    for (a, b), v in zip(_LEAVES, flat):
        tree.setdefault(a, {})[b] = v
    return tree


def _check(xp_fb: torch.Tensor, xp_sb: torch.Tensor, weights: list[torch.Tensor]) -> None:
    tensors = [xp_fb, xp_sb, *weights]
    if xp_fb.device.type != "cuda" or any(a.device != xp_fb.device for a in tensors):
        raise ValueError(f"xp_fb, xp_sb and the weights must be on one CUDA device, got "
                         f"{[str(a.device) for a in tensors]}")
    if any(a.dtype != torch.float32 for a in tensors):
        raise TypeError(f"xp_fb, xp_sb and the weights must be float32, got "
                        f"{[a.dtype for a in tensors]}")
    if xp_fb.ndim != 3 or xp_sb.ndim != 4:
        raise ValueError(f"want xp_fb (B, T, 4Hfb) and xp_sb (B, T, F, 4Hsb), got "
                         f"{tuple(xp_fb.shape)}, {tuple(xp_sb.shape)}")
    b, t, h4f = xp_fb.shape
    f, h4s = xp_sb.shape[2], xp_sb.shape[3]
    hf, hs = h4f // 4, h4s // 4
    w_fb, w_out, b_out, w_ih_sb, w_sb = weights
    if (tuple(xp_sb.shape[:2]) != (b, t) or h4f != 4 * hf or h4s != 4 * hs
            or min(b, t, f, hf, hs) < 1 or tuple(w_fb.shape) != (h4f, hf)
            or tuple(w_out.shape) != (f, hf)
            or tuple(b_out.shape) != (f,) or w_ih_sb.ndim != 2 or w_ih_sb.shape[0] != h4s
            or tuple(w_sb.shape) != (h4s, hs)):
        raise ValueError(
            f"want xp_fb (B, T, 4Hfb), xp_sb (B, T, F, 4Hsb), fb W_hh (4Hfb, Hfb), W_out "
            f"(F, Hfb), b_out (F,), sb W_ih (4Hsb, I), sb W_hh (4Hsb, Hsb) with B, T, F, H >= 1, "
            f"got {[tuple(a.shape) for a in tensors]}")
    if not (xp_fb.is_contiguous() and xp_sb.is_contiguous()):
        raise ValueError("xp_fb and xp_sb must be contiguous")


def joint_recurrence(params: dict, xp_fb: torch.Tensor, xp_sb: torch.Tensor) -> torch.Tensor:
    """The joint recurrence over the hoisted projections ``xp_fb`` (B, T,
    4Hfb) and ``xp_sb`` (B, T, F, 4Hsb) with the weights in ``params`` (the
    FullSubNet tree) -> the sub-band hidden sequence (B, T, F, Hsb), from
    zero state.

    A CUDA tensor launches K11 (or raises: not fp32, not contiguous, a zero
    size, a B whose rows and full-band state one CTA's shared memory cannot
    hold, a grid the card cannot hold co-resident); a CPU tensor takes the
    plain loop.
    """
    if xp_fb.device.type == "cpu":
        from aec_tpu_torch.models.fullsubnet import _joint_scan_hs

        return _joint_scan_hs(params, xp_fb, xp_sb)
    weights = [params[a][b] for a, b in _LEAVES]
    _check(xp_fb, xp_sb, weights)
    w_fb, w_out, b_out, w_ih_sb, w_sb = (w.detach() for w in weights)
    lib = _lib()
    b, t, h4f = xp_fb.shape
    f, h4s = xp_sb.shape[2], xp_sb.shape[3]
    hf, hs, dev = h4f // 4, h4s // 4, xp_fb.device.index
    _build.check_smem(lib.aec_fsn_smem(b, f, hf, hs, dev), xp_fb.device,
                      "the FullSubNet joint kernel (the sub-band W_hh, rows and h_fb in every CTA)")
    # held until the launch is enqueued
    w_fb, w_out, b_out = w_fb.contiguous(), w_out.contiguous(), b_out.contiguous()
    w_col, w_sb_t = w_ih_sb[:, -1].contiguous(), w_sb.T.contiguous()
    hbuf = xp_fb.new_empty((2, b, hf))
    ys = xp_fb.new_empty((b, t, f, hs))
    err = lib.aec_fsn(
        _build.ptr(xp_fb), _build.ptr(xp_sb), _build.ptr(w_fb), _build.ptr(w_out),
        _build.ptr(b_out), _build.ptr(w_col), _build.ptr(w_sb_t), _build.ptr(hbuf),
        _build.ptr(ys), b, t, f, hf, hs, dev, _build.stream_of(xp_fb),
    )
    _build.check(err, "fullsubnet")
    joint_recurrence.launches += 1
    return ys


joint_recurrence.launches = 0


class FsnJointFused(torch.autograd.Function):
    """``(xp_fb, xp_sb, *the 5 weights) -> hs_seq``: forward through K11
    (plain on the CPU), backward by recomputing the plain joint loop."""

    @staticmethod
    def forward(ctx, xp_fb, xp_sb, *weights):
        ctx.save_for_backward(xp_fb, xp_sb, *weights)
        return joint_recurrence(_params(weights), xp_fb.contiguous(), xp_sb.contiguous())

    @staticmethod
    def backward(ctx, g):
        from aec_tpu_torch.models.fullsubnet import _joint_scan_hs

        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _joint_scan_hs(_params(leaves[2:]), leaves[0], leaves[1])
            need = [t for t, n in zip(leaves, ctx.needs_input_grad) if n]
            grads = iter(torch.autograd.grad(out, need, g))
        return tuple(next(grads) if n else None for n in ctx.needs_input_grad)


def fsn_joint_fused(params: dict, xp_fb: torch.Tensor, xp_sb: torch.Tensor) -> torch.Tensor:
    """The fused joint recurrence, differentiable in both projections and the
    weights it reads: ([B, T, 4Hfb], [B, T, F, 4Hsb]) -> [B, T, F, Hsb]."""
    return FsnJointFused.apply(xp_fb, xp_sb, *(params[a][b] for a, b in _LEAVES))
