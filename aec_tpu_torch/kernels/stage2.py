"""Kernel K2: batched LittleNet stage 2 as three passes over all frames.

Replaces ``aec_tpu/kernels/pallas_stage2.py:100`` (``little_net_apply_fused``,
``pallas_call`` at ``:164``; wrapper ``little_net_apply_fused_wav`` at
``:207``). Of a LittleNet frame only the GRU state recurs, so the kernel runs
as three phases (``csrc/stage2.cu``'s header has the design and the
reckoning; phases A and C sum over the ERB matrix's nonzero ranges,
:func:`erb_support`, made once per ERB matrix):

- A, "analyse": CTAs parallel over (utterance, run of frames): real FFTs of
  the windowed lin and far frames (``csrc/fft.cuh``, plan and twiddles from
  :mod:`kernels.fft_plan`), magnitudes, ERB projections and the GRU input
  projection, written to device memory;
- B, "recur": the GRU over all frames on K8 (:func:`kernels.gru.gru_recurrence`);
- C, "synthesise": parallel over runs again: the mask net, the
  back-projection gain, the inverse FFT and the OLA; each run also
  synthesises the frame before it for its tail.

A hop whose FFT has no radix plan (a prime factor other than 2, 3, 5) runs
phases A and C on dense transforms over the stage-2 bases instead;
``transforms`` counts which ran. :func:`little_net_apply_phased` is a
plain-torch model of the three phases (fft_plan's model of the FFTs, the
runs and their seams) for the CPU tests.

:func:`little_net_apply_fused_plain` is its plain version: the per-frame
recurrence in torch, which the wrapper takes for CPU tensors only. The
frame/OLA bookkeeping follows the JAX kernel: one trailing zero flush block,
frame f's output completes block f - 1 (frame 0 completes nothing), and the
mask has ``Tb + 1`` frames. The interior OLA envelope is exactly periodic, so
the recurrence equals the offline ``little_net_apply`` to fp32 round-off.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict

import torch
import torch.nn.functional as F

from aec_tpu_torch.dsp.stft import StftConfig, magnitude, split_complex
from aec_tpu_torch.kernels import _build, fft_plan
from aec_tpu_torch.kernels.consts import stage2_consts
from aec_tpu_torch.kernels.gru import folded_projection, gru_recurrence, gru_recurrence_plain
from aec_tpu_torch.models.little_net import LittleNet, _pseudo_norm
from aec_tpu_torch.ops.gru import gru_cell

# CTAs a phase should have per SM before its runs of frames grow
CTAS_PER_SM = 1
MAX_RUN = 8  # frames per CTA, at most (csrc/stage2.cu kMaxRun)
SUPPORTS_KEPT = 8  # ERB supports cached, newest last


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("stage2")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_stage2_analyse.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, i, p, p, p, p, p, p, i,
                                       p]
    lib.aec_stage2_synthesise.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p, p, i, p, p, p, p, p,
                                          p, p, p, p, i, i, p]
    lib.aec_stage2_analyse.restype = lib.aec_stage2_synthesise.restype = ctypes.c_int
    lib.aec_stage2_smem.argtypes = [i, i, i, i]
    lib.aec_stage2_smem.restype = ctypes.c_longlong
    return lib


_SUPPORTS: OrderedDict = OrderedDict()


def erb_support(erb: torch.Tensor) -> torch.Tensor:
    """The ERB matrix's (K, E) support as int32 (2E + 2K,) on its device,
    which the stage-2 device code (K2's phases, the K3 / K4 frame) sums
    over: for each band the first and one past the last bin with a nonzero
    weight (K and 0 for an empty band), then the same for each bin over the
    bands (E and 0). Cached on ``erb``'s ``data_ptr()``, ``_version`` and
    shape; an entry holds ``erb``, so no other tensor takes its address
    while it lives."""
    key = (erb.device, erb.data_ptr(), erb._version, erb.shape)
    hit = _SUPPORTS.get(key)
    if hit is not None:
        _SUPPORTS.move_to_end(key)
        return hit[1]
    nz = erb != 0
    k, e = nz.shape

    def ranges(m: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        idx = torch.arange(n, device=m.device)[:, None]  # along dim 0 of m (n, cols)
        return torch.where(m, idx, n).amin(0), torch.where(m, idx + 1, 0).amax(0)

    sup = torch.cat([*ranges(nz, k), *ranges(nz.T, e)]).to(torch.int32)
    _SUPPORTS[key] = (erb, sup)
    while len(_SUPPORTS) > SUPPORTS_KEPT:
        _SUPPORTS.popitem(last=False)
    return sup


def little_net_apply_fused_plain(
    net: LittleNet, lin_blocks: torch.Tensor, far_blocks: torch.Tensor,
    erb: torch.Tensor, cfg: StftConfig = StftConfig(), *, gain_norm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: blocks (B, Tb, hop) -> (out (B, Tb, hop),
    mask (B, Tb + 1, E)), one frame per loop step, in the blocks' dtype (a
    float64 net and blocks give the fp64 evaluation the kernel's round-off
    is measured against)."""
    b, t_blocks, hop = lin_blocks.shape
    c = {k: v.to(lin_blocks.dtype) for k, v in stage2_consts(cfg, lin_blocks.device).items()}
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


def check_net(net: LittleNet, erb: torch.Tensor, cfg: StftConfig,
              device: torch.device) -> None:
    """Raise unless the net and erb are fp32 on the CUDA ``device``, the STFT
    is the 2x-overlap geometry (window = FFT = 2 hop) the stage-2 device code
    computes, and the net is a width-1 LittleNet (GRU hidden = ERB bands, as
    JAX's ``bl_common.stage2_frame_step`` carries it)."""
    tensors = [erb, *net.parameters()]
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"erb and the net's weights must be on the inputs' CUDA device {device}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("erb and the net's weights must be float32")
    if not cfg.win_len == cfg.fft_len == 2 * cfg.hop:
        raise ValueError(f"the stage-2 kernels need window = FFT = 2 * hop, got {cfg}")
    if erb.ndim != 2 or erb.shape[0] != cfg.n_freqs or net.hidden != erb.shape[1]:
        raise ValueError(
            f"the stage-2 kernels need a width-1 LittleNet (GRU hidden = ERB bands) and erb "
            f"(K = {cfg.n_freqs}, E), got erb {tuple(erb.shape)} and GRU hidden {net.hidden}"
        )


def _check(net: LittleNet, lin: torch.Tensor, far: torch.Tensor, erb: torch.Tensor,
           cfg: StftConfig) -> None:
    if lin.device.type != "cuda" or far.device != lin.device:
        raise ValueError(f"lin/far must be on one CUDA device, got {lin.device}, {far.device}")
    if lin.dtype != torch.float32 or far.dtype != torch.float32:
        raise TypeError(f"lin/far must be float32, got {lin.dtype}, {far.dtype}")
    if lin.ndim != 3 or lin.shape != far.shape or lin.shape[-1] != cfg.hop:
        raise ValueError(
            f"lin/far must be (B, Tb, {cfg.hop}) of one shape, got {lin.shape}, {far.shape}"
        )
    if not (lin.is_contiguous() and far.is_contiguous()):
        raise ValueError("lin/far must be contiguous")
    check_net(net, erb, cfg, lin.device)


def frames_per_cta(batch: int, frames: int, sms: int, fits=lambda run: True) -> int:
    """Frames per CTA of phases A and C: the longest run (``MAX_RUN``, 4, 2
    or 1) whose layout ``fits`` one CTA's shared memory and that still gives
    every SM ``CTAS_PER_SM`` CTAs; longer runs share each FFT pass and
    weight read among more frames, shorter ones spread a small batch over
    the card (and a long hop's frames over less shared memory)."""
    run = MAX_RUN
    while run > 1 and (batch * -(-frames // run) < CTAS_PER_SM * sms or not fits(run)):
        run //= 2
    return run


def launch_phases(lib: ctypes.CDLL, net: LittleNet, lin: torch.Tensor, far: torch.Tensor,
                  erb: torch.Tensor, cfg: StftConfig, gain_norm: bool,
                  run: int) -> tuple[torch.Tensor, torch.Tensor, str]:
    """K2's three launches on checked inputs, ``run`` frames per CTA of
    phases A and C -> (out, mask, the transforms that ran: ``"fft"`` or
    ``"dense"``). Every launch goes on the inputs' stream, and each holds its
    operands until it is enqueued: memory freed after that is reused only by
    later work on the same stream."""
    b, t_blocks, hop = lin.shape
    bands, frames, dev = erb.shape[-1], t_blocks + 1, lin.device
    for phase in (0, 1):
        _build.check_smem(lib.aec_stage2_smem(hop, bands, run, phase), dev, "the stage-2 kernel")
    plan = fft_plan.radix_plan(hop)
    tw = None if plan is None else _build.ptr(fft_plan.twiddles(hop, dev))
    radix = None if plan is None else (ctypes.c_int * len(plan))(*plan)
    c = stage2_consts(cfg, dev)
    gp = {k: v.detach() for k, v in net.gru_params().items()}
    transforms = [tw, _build.ptr(c["window"]), radix, 0 if plan is None else len(plan),
                  _build.ptr(c["analysis"])]
    geometry = (b, t_blocks, hop, bands, run)
    stream = _build.stream_of(lin)

    me = lin.new_empty((b, frames, bands))
    xp = lin.new_empty((b, frames, 3 * bands))
    sup = erb_support(erb)
    keep = [erb.contiguous(), sup, gp["w_ih"].T.contiguous(), gp["b_ih"], gp["b_hh"]]
    err = lib.aec_stage2_analyse(
        _build.ptr(lin), _build.ptr(far), _build.ptr(me), _build.ptr(xp), *geometry, *transforms,
        *map(_build.ptr, keep), dev.index, stream,
    )
    _build.check(err, "stage2 (analyse)")
    hs = gru_recurrence(xp, gp["w_hh"], gp["b_hh"][2 * bands:], lin.new_zeros((b, bands)))
    out = torch.empty_like(lin)
    mask = lin.new_empty((b, frames, bands))
    keep = [c["synthesis"], sup, erb.T.contiguous(), net.linear1.weight.detach().T.contiguous(),
            net.linear1.bias.detach(), net.linear2.weight.detach().T.contiguous(),
            net.linear2.bias.detach(), c["inv_env"]]
    err = lib.aec_stage2_synthesise(
        _build.ptr(lin), _build.ptr(hs), _build.ptr(me), _build.ptr(out), _build.ptr(mask),
        *geometry, *transforms, *map(_build.ptr, keep), int(gain_norm), dev.index, stream,
    )
    _build.check(err, "stage2 (synthesise)")
    return out, mask, "dense" if plan is None else "fft"


def little_net_apply_fused(
    net: LittleNet, lin_blocks: torch.Tensor, far_blocks: torch.Tensor,
    erb: torch.Tensor, cfg: StftConfig = StftConfig(), *, gain_norm: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocks (B, Tb, hop) -> (out (B, Tb, hop), mask (B, Tb + 1, E)).

    A CUDA tensor launches the kernel's phases A and C and K8 between them
    (or raises); a CPU tensor takes the plain recurrence. ``transforms``
    counts the launches on FFTs and on dense transforms (a hop with a prime
    factor other than 2, 3, 5).
    """
    if lin_blocks.device.type == "cpu":
        return little_net_apply_fused_plain(
            net, lin_blocks, far_blocks, erb, cfg, gain_norm=gain_norm
        )
    _check(net, lin_blocks, far_blocks, erb, cfg)
    lib = _lib()
    b, t_blocks, hop = lin_blocks.shape
    props = torch.cuda.get_device_properties(lin_blocks.device)
    run = frames_per_cta(
        b, t_blocks + 1, props.multi_processor_count,
        lambda r: max(lib.aec_stage2_smem(hop, erb.shape[-1], r, phase) for phase in (0, 1))
        <= props.shared_memory_per_block_optin,
    )
    out, mask, transforms = launch_phases(lib, net, lin_blocks, far_blocks, erb, cfg, gain_norm,
                                          run)
    little_net_apply_fused.transforms[transforms] += 1
    little_net_apply_fused.launches += 1
    return out, mask


little_net_apply_fused.launches = 0
little_net_apply_fused.transforms = {"fft": 0, "dense": 0}


def little_net_apply_phased(
    net: LittleNet, lin_blocks: torch.Tensor, far_blocks: torch.Tensor,
    erb: torch.Tensor, cfg: StftConfig = StftConfig(), *, gain_norm: bool = False,
    run: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A plain-torch model of K2's three phases on the FFT route, for the
    CPU tests: blocks (B, Tb, hop) -> (out, mask) as
    :func:`little_net_apply_fused_plain`. Frames are cut into runs of
    ``run``; phase A transforms each run's windowed frames with
    :func:`fft_plan.rfft` (the kernel's Stockham schedule), phase B is
    K8's recurrence, and phase C synthesises each run and the frame before
    it (the seam) with :func:`fft_plan.irfft`, as the kernel's CTAs do."""
    b, t_blocks, hop = lin_blocks.shape
    frames, c = t_blocks + 1, stage2_consts(cfg, lin_blocks.device)
    window, gp = c["window"], net.gru_params()
    hidden = net.hidden

    def spectra(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """ri spectra (B, hi - lo, 2K) of the windowed frames lo .. hi - 1."""
        padded = F.pad(x, (0, 0, 1, 1))  # zero blocks before block 0 and after block Tb - 1
        fr = torch.cat([padded[:, lo:hi], padded[:, lo + 1:hi + 1]], -1)
        return fft_plan.rfft(fr * window, hop)

    me, xp = [], []
    for lo in range(0, frames, run):  # A
        hi = min(lo + run, frames)
        m_lin = magnitude(spectra(lin_blocks, lo, hi)) @ erb
        m_far = magnitude(spectra(far_blocks, lo, hi)) @ erb
        me.append(m_lin)
        xp.append(folded_projection(gp, torch.cat([m_lin, torch.abs(m_lin - m_far)], -1)))
    me, xp = torch.cat(me, 1), torch.cat(xp, 1)
    hs = gru_recurrence_plain(xp, gp["w_hh"], gp["b_hh"][2 * hidden:],  # B
                              lin_blocks.new_zeros((b, hidden)))
    out = lin_blocks.new_empty((b, t_blocks, hop))
    masks = lin_blocks.new_empty((b, frames, erb.shape[-1]))
    for f0 in range(0, frames, run):  # C
        f1 = min(f0 + run, frames)
        g0 = max(f0 - 1, 0)
        h, m = hs[:, g0:f1], me[:, g0:f1]
        mask = torch.sigmoid(net.linear2(torch.relu(net.linear1(torch.cat([h, m], -1)))))
        gain = (mask * m) @ erb.T
        if gain_norm:
            gain = gain / (m @ erb.T + 1e-9)
        re, im = split_complex(spectra(lin_blocks, g0, f1))
        y = torch.cat([gain * re, gain * im], -1)
        head = window[:hop] * fft_plan.irfft(y, hop, "head")
        tail = window[hop:] * fft_plan.irfft(y, hop, "tail")
        masks[:, f0:f1] = mask[:, f0 - g0:]
        first = max(f0, 1)
        out[:, first - 1:f1 - 1] = (tail[:, first - 1 - g0:f1 - 1 - g0]
                                    + head[:, first - g0:]) * c["inv_env"] + 1e-9
    return out, masks


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
