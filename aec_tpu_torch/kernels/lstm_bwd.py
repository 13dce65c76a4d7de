"""Kernel K9b: the LSTM recurrence's backward as one CUDA launch.

Replaces the backwards of ``aec_tpu/kernels/pallas_lstm.py``'s custom VJP
``complex_lstm_scan_fused`` (``_bwd``, ``:341-350``) and of
``aec_tpu/kernels/pallas_fullsubnet.py``'s ``fsn_joint_fused`` (``_bwd``,
``:199-217``). JAX recomputes through the scan and takes ``jax.vjp`` of it,
which XLA compiles into one loop on the device; eager PyTorch would run that
loop as a chain of launches a step, slicing and zero-filling the whole
projection's gradient at each, so the port's counterpart of the compiled
loop is a kernel on the gates the forward kernels save (K9 and K11 with
``save``). The kernel is ``csrc/lstm_bwd.cu`` (the source's header has the
design and the reckoning): one persistent grid of co-resident CTAs, each
owning a run of rows and a chunk of units with their columns of W_hh on
chip; plan (a) puts every unit in one CTA and splits the rows (a narrow
W_hh), plan (b) splits the units and exchanges each step's gradients
through device memory, ordered by a counter a group.

Layout: G groups, each with its W_hh (4H, H), each over B x F rows (B
sequences of T steps, F rows a step): ``g_ys`` (G, B, T, F, H), ``saved``
(G, B, T, F, 5H) = each step's activated i, f, g, o and c, ``dxp`` (G, B, T,
F, 4H). DCCRN's grouped LSTM is (2, 2 batch, T, 1, .), FullSubNet's sub band
(1, batch, T, 161, .) as its tensors lie, its full band (1, batch, T, 1, .).
The weight gradients are products over all rows outside the kernel.

Host side. :func:`backward_plan` chooses the plan, each warp's columns and
k-slice and where its quads of W lie; :func:`pack_backward` builds that
layout, cached per weight tensor by ``kernels/lstm.py``'s
:func:`~aec_tpu_torch.kernels.lstm.packed_weights` (keyed on ``data_ptr()``
and ``_version``). :func:`unpack_backward` and :func:`backward_modeled`
model the layout and the kernel's summation order in plain torch for the CPU
tests. :func:`lstm_backward` is the wrapper (a CUDA tensor launches K9b or
raises, a CPU tensor takes :func:`lstm_backward_plain`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.lstm import LANES, REG_QUADS, THREADS, WARPS, packed_weights


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_lstm_bwd.argtypes = [p] * 5 + [i] * 15 + [p]
    lib.aec_lstm_bwd.restype = ctypes.c_int
    if lib.aec_lstm_bwd_reg_quads() != REG_QUADS:
        raise RuntimeError("csrc/lstm_bwd.cu holds another number of register quads than "
                           "kernels/lstm_bwd.py packs")
    return lib


def lstm_backward_plain(g_ys: torch.Tensor, saved: torch.Tensor,
                        w_hh: torch.Tensor) -> torch.Tensor:
    """K9b's arithmetic in torch, one reverse step per loop iteration: the
    VJP of the recurrence from zero state given the cotangent of every
    output step ``g_ys`` (G, B, T, F, H), the ``saved`` gates (G, B, T, F,
    5H) and ``w_hh`` (G, 4H, H) -> dxp (G, B, T, F, 4H), the gradient of
    each step's pre-activations [i, f, g, o] (that is, of the hoisted
    projection)."""
    hidden = g_ys.shape[-1]
    carry_h = carry_c = torch.zeros_like(g_ys[:, :, 0])
    out = []
    for t in range(g_ys.shape[2] - 1, -1, -1):
        i, f, g, o, c = torch.split(saved[:, :, t], hidden, dim=-1)
        c_prev = saved[:, :, t - 1, :, 4 * hidden:] if t > 0 else torch.zeros_like(c)
        dh = carry_h + g_ys[:, :, t]
        tc = torch.tanh(c)
        dc = carry_c + dh * o * (1.0 - tc * tc)
        d = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                       dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
        carry_c = dc * f
        carry_h = torch.matmul(d.reshape(d.shape[0], -1, 4 * hidden), w_hh).reshape(dh.shape)
        out.append(d)
    return torch.stack(out[::-1], dim=2)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """Where K9b keeps W_hh. CTA ((g runs + run) nchunk + chunk) owns rows
    [run ``run_rows``, + ``run_rows``) of group g and units [chunk U, chunk U
    + U), the CTA's columns c < U (column c: W_hh[:, chunk U + c], 4H long).
    Warp w sums columns (w % wc) cw + i (i < ``cw``) over k-slice w // wc of
    the 4H (``ks`` slices of 32 ``npos`` quads; wc = 16 / ks); its lane l
    holds the quads 32 npos slice + l + 32 j (j < ``npos``) of its columns:
    in registers for j < ``jreg``, in shared memory for j < ``jreg + jsm``,
    else read from L2 each sweep. A step stages ``stage`` rows of the next
    step's gradients in shared memory at a time."""

    groups: int
    rows: int
    hidden: int
    runs: int
    run_rows: int
    units: int
    nchunk: int
    cw: int
    ks: int
    npos: int
    jreg: int
    jsm: int
    stage: int
    smem: int  # bytes of shared memory a CTA

    @property
    def wc(self) -> int:
        return WARPS // self.ks

    @property
    def cols(self) -> int:
        return self.wc * self.cw

    @property
    def ctas(self) -> int:
        return self.groups * self.runs * self.nchunk

    @property
    def layout(self) -> tuple:
        """What the packed weights depend on."""
        return (self.units, self.nchunk, self.cw, self.ks, self.npos)


def _warp_layout(units: int, hidden: int, cw: int | None = None) -> tuple[int, int, int] | None:
    """(cw, ks, npos) with the fewest padded FMA slots a row for U columns
    of length 4H = H quads, the widest cw among equals (each staged quad
    then serves more columns); ``cw`` forces the columns a warp. None where
    16 warps of cw columns cannot hold U."""
    best = None
    for cw in (16, 8, 4, 2, 1) if cw is None else (cw,):
        wc = 1 << (-(-units // cw) - 1).bit_length()
        if wc > WARPS:
            continue
        ks = WARPS // wc
        npos = -(-hidden // (LANES * ks))
        slots = wc * cw * ks * LANES * npos
        if best is None or slots < best[0]:
            best = (slots, cw, ks, npos)
    return None if best is None else best[1:]


def backward_plan(groups: int, rows: int, hidden: int, sms: int, smem_optin: int,
                  reg_quads: int = REG_QUADS, cw: int | None = None) -> BackwardPlan:
    """K9b's layout for G = ``groups`` recurrences of R = ``rows`` rows at H
    = ``hidden`` on a card of ``sms`` SMs giving a CTA ``smem_optin`` bytes
    of shared memory. Plan (a) where all of W_hh^T fits one CTA's registers
    and shared memory beside its rows: every unit in each CTA, the rows in
    runs over about one CTA an SM. Plan (b) otherwise: one run of all R
    rows, the units in chunks of U (at most one CTA an SM, 16 to 64 units),
    W's positions in registers, then shared memory, the rest from L2. Each
    plan keeps W's shared positions first and stages as many rows as the
    rest of the shared memory holds (the wrapper raises where not one
    fits). ``cw`` forces the columns a warp (``kernels/lstm_bwd_costs.py``)."""

    def make(units: int, nchunk: int, runs: int) -> BackwardPlan | None:
        run_rows = -(-rows // runs)
        runs = -(-rows // run_rows)
        layout = _warp_layout(units, hidden, cw)
        if layout is None:
            return None
        cw_, ks, npos = layout
        jreg = min(reg_quads // cw_, npos)
        fixed = 4 * (ks * run_rows * (WARPS // ks) * cw_ + run_rows * units)
        row, pos = 16 * hidden, cw_ * THREADS * 16  # bytes: a staged row, a shared position
        jsm = max(0, min(npos - jreg, (smem_optin - fixed - row) // pos))
        stage = max(1, min(run_rows, (smem_optin - fixed - jsm * pos) // row))
        return BackwardPlan(groups, rows, hidden, runs, run_rows, units, nchunk, cw_, ks, npos,
                            jreg, jsm, stage, fixed + jsm * pos + stage * row)

    if hidden <= WARPS * 16:  # the widest a CTA's columns go
        a = make(hidden, 1, max(1, min(rows, sms // groups)))
        if a is not None and a.jreg + a.jsm == a.npos and a.smem <= smem_optin:
            return a
    units = min(max(-(-hidden // max(1, sms // groups)), 16), 64, hidden)
    b = make(units, -(-hidden // units), 1)
    if b is None:
        raise ValueError(f"{units} columns a CTA do not fit 16 warps of {cw} columns")
    return b


def pack_backward(w_hh: torch.Tensor, plan: BackwardPlan) -> torch.Tensor:
    """``W_hh`` (G, 4H, H) -> (G nchunk, npos cw, 512, 4), as
    :class:`BackwardPlan` places it: quad j cw + i of thread w 32 + l of
    block g nchunk + chunk is ``W_hh[g][4 k + e, chunk U + c]``, e < 4, for
    column c = (w % wc) cw + i and quad k = 32 npos (w // wc) + l + 32 j;
    zero past H and for the columns past U. One op chain per weight tensor,
    never per call."""
    g, u, h, nchunk, npos = plan.groups, plan.units, plan.hidden, plan.nchunk, plan.npos
    kq = plan.ks * LANES * npos
    w = F.pad(w_hh.transpose(1, 2), (0, 4 * kq - 4 * h, 0, nchunk * u - h))  # (G, units, 4H)
    w = w.reshape(g, nchunk, u, 4 * kq)
    w = F.pad(w, (0, 0, 0, plan.cols - u))
    w = w.reshape(g, nchunk, plan.wc, plan.cw, plan.ks, npos, LANES, 4)
    w = w.permute(0, 1, 5, 3, 4, 2, 6, 7)  # [g, chunk, j, i, slice, wc, l, e]
    return w.reshape(g * nchunk, npos * plan.cw, THREADS, 4).contiguous()


def unpack_backward(packed: torch.Tensor, plan: BackwardPlan) -> torch.Tensor:
    """The inverse of :func:`pack_backward`: -> ``W_hh`` (G, 4H, H)."""
    g, u, h, nchunk, npos = plan.groups, plan.units, plan.hidden, plan.nchunk, plan.npos
    w = packed.reshape(g, nchunk, npos, plan.cw, plan.ks, plan.wc, LANES, 4)
    w = w.permute(0, 1, 5, 3, 4, 2, 6, 7).reshape(g, nchunk, plan.cols, -1)[:, :, :u]
    return w.reshape(g, nchunk * u, -1)[:, :h, :4 * h].transpose(1, 2)


def backward_modeled(g_ys: torch.Tensor, saved: torch.Tensor, packed: torch.Tensor,
                     plan: BackwardPlan) -> torch.Tensor:
    """K9b from the layout, in the kernel's summation order: each lane's dot
    over its quads in k order (registers, shared memory, L2; fp32 products
    and sums here, FMAs in the kernel), the warp's 32 lanes summed as a tree
    whose first level pairs lanes l and l + 16, the k-slices' sums added in
    slice order, then the cell. A model for the CPU tests: g_ys (G, R, T, H),
    saved (G, R, T, 5H) -> dxp (G, R, T, 4H)."""
    g, r, t, h = g_ys.shape
    u, nchunk, npos, ks, wc, cw = plan.units, plan.nchunk, plan.npos, plan.ks, plan.wc, plan.cw
    kq = ks * LANES * npos
    w = packed.reshape(g, nchunk, npos, cw, ks, wc, LANES, 4).permute(0, 1, 4, 5, 3, 6, 2, 7)
    w = w.reshape(g, nchunk, 1, ks, wc, cw, LANES, npos * 4)  # [g, chunk, -, q, cg, i, l, k]
    carry_c = g_ys.new_zeros((g, r, h))
    d = None
    out = []
    for step in range(t - 1, -1, -1):
        if d is None:
            ch = g_ys.new_zeros((g, r, h))
        else:
            dv = F.pad(d, (0, 4 * kq - 4 * h)).reshape(g, r, ks, npos, LANES, 4)
            dv = dv.permute(0, 1, 2, 4, 3, 5).reshape(g, 1, r, ks, 1, 1, LANES, npos * 4)
            acc = g_ys.new_zeros((g, nchunk, r, ks, wc, cw, LANES))
            for k in range(npos * 4):
                acc = acc + dv[..., k] * w[..., k]
            for half in (16, 8, 4, 2, 1):
                acc = acc[..., :half] + acc[..., half:]
            pre = acc[..., 0].reshape(g, nchunk, r, ks, plan.cols)[..., :u]
            ch = pre[:, :, :, 0]
            for q in range(1, ks):
                ch = ch + pre[:, :, :, q]
            ch = ch.permute(0, 2, 1, 3).reshape(g, r, nchunk * u)[..., :h]
        i, f, gg, o, c = torch.split(saved[:, :, step], h, dim=-1)
        c_prev = saved[:, :, step - 1, 4 * h:] if step > 0 else torch.zeros_like(c)
        dh = ch + g_ys[:, :, step]
        tc = torch.tanh(c)
        dc = carry_c + dh * o * (1.0 - tc * tc)
        d = torch.cat([dc * gg * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                       dc * i * (1.0 - gg * gg), dh * tc * o * (1.0 - o)], dim=-1)
        carry_c = dc * f
        out.append(d)
    return torch.stack(out[::-1], dim=2)


# ---------------------------------------------------------------- the wrapper


def card_plan(groups: int, rows: int, hidden: int, device: torch.device,
              cw: int | None = None) -> BackwardPlan:
    """:func:`backward_plan` for this card."""
    props = torch.cuda.get_device_properties(device)
    return backward_plan(groups, rows, hidden, props.multi_processor_count,
                         props.shared_memory_per_block_optin, cw=cw)


def lstm_backward(g_ys: torch.Tensor, saved: torch.Tensor,
                  w_hh: torch.Tensor | Sequence[torch.Tensor]) -> torch.Tensor:
    """The recurrence's VJP (:func:`lstm_backward_plain`'s contract):
    ``g_ys`` (G, B, T, F, H), ``saved`` (G, B, T, F, 5H) from K9 or K11 with
    ``save``, ``w_hh`` (G, 4H, H) or the G groups' (4H, H) tensors -> dxp
    (G, B, T, F, 4H).

    A CUDA tensor launches K9b (or raises: not fp32, not contiguous, T = 0,
    rows that one CTA's shared memory cannot stage, a grid the card cannot
    hold co-resident), with W_hh packed at its first call and cached; a CPU
    tensor takes the plain loop.
    """
    ws = [w_hh] if isinstance(w_hh, torch.Tensor) else list(w_hh)
    if g_ys.device.type == "cpu":
        return lstm_backward_plain(g_ys, saved, ws[0] if len(ws) == 1 else torch.stack(ws))
    tensors = [g_ys, saved, *ws]
    if any(a.device != g_ys.device for a in tensors):
        raise ValueError(f"g_ys, saved and w_hh must be on one CUDA device, got "
                         f"{[str(a.device) for a in tensors]}")
    if any(a.dtype != torch.float32 for a in tensors):
        raise TypeError(f"g_ys, saved and w_hh must be float32, got {[a.dtype for a in tensors]}")
    g, b, t, f, h = g_ys.shape
    want_w = [(g, 4 * h, h)] if ws[0].ndim == 3 else [(4 * h, h)] * g
    if (tuple(saved.shape) != (g, b, t, f, 5 * h) or [tuple(w.shape) for w in ws] != want_w
            or min(g, b, t, f, h) < 1):
        raise ValueError(f"want g_ys (G, B, T, F, H), saved (G, B, T, F, 5H), w_hh (G, 4H, H) "
                         f"or G of (4H, H), all sizes >= 1, got {tuple(g_ys.shape)}, "
                         f"{tuple(saved.shape)}, {[tuple(w.shape) for w in ws]}")
    if not (g_ys.is_contiguous() and saved.is_contiguous()):
        raise ValueError("g_ys and saved must be contiguous")
    dxp = launch(card_plan(g, b * f, h, g_ys.device), g_ys, saved, ws)
    lstm_backward.launches += 1
    return dxp


lstm_backward.launches = 0


def launch(plan: BackwardPlan, g_ys: torch.Tensor, saved: torch.Tensor,
           ws: list[torch.Tensor]) -> torch.Tensor:
    """One launch of K9b at ``plan`` on checked inputs -> dxp; raises where
    the plan needs more shared memory than a CTA has."""
    g, b, t, f, h = g_ys.shape
    _build.check_smem(plan.smem, g_ys.device, "the LSTM backward kernel (a run's rows of the "
                      "k-slices' sums and carry_c, and one staged row, in every CTA)")
    packed = packed_weights(ws, plan, pack_backward)
    counters = torch.zeros(g * plan.runs, dtype=torch.int32, device=g_ys.device)
    dxp = g_ys.new_empty((g, b, t, f, 4 * h))
    err = _lib().aec_lstm_bwd(
        _build.ptr(g_ys), _build.ptr(saved), _build.ptr(packed), _build.ptr(counters),
        _build.ptr(dxp), g, b, t, f, h, plan.runs, plan.run_rows, plan.units, plan.nchunk,
        plan.cw, plan.ks, plan.npos, plan.jreg, plan.jsm, plan.stage, g_ys.device.index,
        _build.stream_of(g_ys))
    _build.check(err, "lstm_bwd")
    return dxp
