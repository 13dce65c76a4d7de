"""Kernel K2: batched LittleNet stage 2, one frame per step, as one CUDA launch.

Replaces ``aec_tpu/kernels/pallas_stage2.py:100`` (``little_net_apply_fused``,
``pallas_call`` at ``:164``; wrapper ``little_net_apply_fused_wav`` at
``:207``). The kernel is ``csrc/stage2.cu`` on the shared frame step of
``csrc/bl_common.cuh``: one CTA per utterance walks the ``Tb + 1`` frames
with the GRU state, OLA tail and previous input blocks in shared memory. It
is bound by L2 bandwidth (the analysis and synthesis bases are re-read every
frame); the source's header has the reckoning and the levers left.

:func:`little_net_apply_fused_plain` is its plain version: the same per-frame
recurrence in torch, which the wrapper takes for CPU tensors only. The
frame/OLA bookkeeping follows the JAX kernel: one trailing zero flush block,
frame f's output completes block f - 1 (frame 0 completes nothing), and the
mask has ``Tb + 1`` frames. The interior OLA envelope is exactly periodic, so
the recurrence equals the offline ``little_net_apply`` to fp32 round-off.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from aec_tpu_torch.dsp.stft import StftConfig, magnitude, split_complex
from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.consts import stage2_consts
from aec_tpu_torch.models.little_net import LittleNet, _pseudo_norm
from aec_tpu_torch.ops.gru import gru_cell

_HOP, _WIN, _BANDS = 256, 512, 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("stage2")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_stage2.argtypes = [p, p, p, p, i, i, *[p] * 13, i, i, p]
    lib.aec_stage2.restype = ctypes.c_int
    return lib


def little_net_apply_fused_plain(
    net: LittleNet, lin_blocks: torch.Tensor, far_blocks: torch.Tensor,
    erb: torch.Tensor, cfg: StftConfig = StftConfig(), *, gain_norm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: blocks (B, Tb, hop) -> (out (B, Tb, hop),
    mask (B, Tb + 1, E)), one frame per loop step."""
    b, t_blocks, hop = lin_blocks.shape
    c = stage2_consts(cfg, lin_blocks.device)
    gp = net.gru_params()
    zero = lin_blocks.new_zeros((b, hop))
    h = lin_blocks.new_zeros((b, net.hidden))
    tail, prev_lin, prev_far = zero, zero, zero
    out = lin_blocks.new_empty((b, t_blocks, hop))
    masks = lin_blocks.new_empty((b, t_blocks + 1, erb.shape[-1]))
    for f in range(t_blocks + 1):
        cur_lin = lin_blocks[:, f] if f < t_blocks else zero
        cur_far = far_blocks[:, f] if f < t_blocks else zero
        spec = torch.cat([prev_lin, cur_lin], -1) @ c["analysis"]  # (B, 2K)
        fspec = torch.cat([prev_far, cur_far], -1) @ c["analysis"]
        prev_lin, prev_far = cur_lin, cur_far
        me = magnitude(spec) @ erb  # (B, E)
        fe = magnitude(fspec) @ erb
        xp = torch.cat([me, torch.abs(me - fe)], -1) @ gp["w_ih"].T + gp["b_ih"]
        h = gru_cell(gp, h, xp)
        mask = torch.sigmoid(net.linear2(torch.relu(net.linear1(torch.cat([h, me], -1)))))
        gain = (mask * me) @ erb.T  # (B, K)
        if gain_norm:
            gain = gain / (me @ erb.T + 1e-9)
        re, im = split_complex(spec)
        syn = torch.cat([gain * re, gain * im], -1) @ c["synthesis"]  # (B, win)
        masks[:, f] = mask
        if f:
            out[:, f - 1] = (tail + syn[:, :hop]) * c["inv_env"] + 1e-9
        tail = syn[:, hop:]
    return out, masks


def _check(net: LittleNet, lin: torch.Tensor, far: torch.Tensor, erb: torch.Tensor,
           cfg: StftConfig) -> None:
    tensors = [lin, far, erb, *net.parameters()]
    if lin.device.type != "cuda" or any(t.device != lin.device for t in tensors):
        raise ValueError("blocks, erb and the net's weights must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("blocks, erb and the net's weights must be float32")
    if lin.ndim != 3 or lin.shape != far.shape:
        raise ValueError(
            f"lin/far must be (B, Tb, hop) of one shape, got {lin.shape}, {far.shape}"
        )
    if not (lin.is_contiguous() and far.is_contiguous()):
        raise ValueError("lin/far must be contiguous")
    if (cfg.hop, cfg.win_len, cfg.fft_len) != (_HOP, _WIN, _WIN) or lin.shape[-1] != _HOP:
        raise ValueError(f"the kernel is built for hop {_HOP}, window/FFT {_WIN}, got {cfg}")
    if tuple(erb.shape) != (cfg.n_freqs, _BANDS) or net.hidden != _BANDS:
        raise ValueError(
            f"the kernel is built for a width-1 LittleNet on {_BANDS} ERB bands, "
            f"got erb {tuple(erb.shape)} and GRU hidden {net.hidden}"
        )


def little_net_apply_fused(
    net: LittleNet, lin_blocks: torch.Tensor, far_blocks: torch.Tensor,
    erb: torch.Tensor, cfg: StftConfig = StftConfig(), *, gain_norm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocks (B, Tb, hop) -> (out (B, Tb, hop), mask (B, Tb + 1, E)).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain recurrence.
    """
    if lin_blocks.device.type == "cpu":
        return little_net_apply_fused_plain(
            net, lin_blocks, far_blocks, erb, cfg, gain_norm=gain_norm
        )
    _check(net, lin_blocks, far_blocks, erb, cfg)
    lib = _lib()
    b, t_blocks, hop = lin_blocks.shape
    out = torch.empty_like(lin_blocks)
    mask = lin_blocks.new_empty((b, t_blocks + 1, _BANDS))
    c = stage2_consts(cfg, lin_blocks.device)
    gp = {k: v.detach() for k, v in net.gru_params().items()}
    # kernel operands; temporaries freed after the call are reused only by
    # later work on this stream, so stream order keeps them valid for the launch
    keep = [
        c["analysis"], c["synthesis"], erb.contiguous(), erb.T.contiguous(),
        gp["w_ih"].T.contiguous(), gp["w_hh"].T.contiguous(), gp["b_ih"], gp["b_hh"],
        net.linear1.weight.detach().T.contiguous(), net.linear1.bias.detach(),
        net.linear2.weight.detach().T.contiguous(), net.linear2.bias.detach(),
        c["inv_env"],
    ]
    err = lib.aec_stage2(
        _build.ptr(lin_blocks), _build.ptr(far_blocks), _build.ptr(out), _build.ptr(mask),
        b, t_blocks, *[_build.ptr(t) for t in keep], int(gain_norm),
        lin_blocks.device.index, _build.stream_of(lin_blocks),
    )
    _build.check(err, "stage2")
    little_net_apply_fused.launches += 1
    return out, mask


little_net_apply_fused.launches = 0


def little_net_apply_fused_wav(
    net: LittleNet, mic: torch.Tensor, ref: torch.Tensor, erb: torch.Tensor,
    cfg: StftConfig = StftConfig(), *, normalize: bool = True,
    per_utt_norm: bool = False, gain_norm: bool = False,
) -> dict[str, torch.Tensor]:
    """Waveform-level stage 2, drop-in for ``little_net_apply``'s ``wav``:
    (B, n) -> {"wav": (B, n), "mask": (B, Tb + 1, E)}. The scalar pseudo-norm
    is a pre-pass in plain torch (a subtraction before the STFT pad)."""
    n = mic.shape[-1]
    if normalize:
        mic = _pseudo_norm(mic, per_utt_norm)
        ref = _pseudo_norm(ref, per_utt_norm)
    rem = (-n) % cfg.hop
    if rem:
        mic, ref = F.pad(mic, (0, rem)), F.pad(ref, (0, rem))

    def blocks(a):
        return a.contiguous().reshape(a.shape[0], -1, cfg.hop)

    out, mask = little_net_apply_fused(
        net, blocks(mic), blocks(ref), erb, cfg, gain_norm=gain_norm
    )
    return {"wav": out.reshape(out.shape[0], -1)[:, :n], "mask": mask}
