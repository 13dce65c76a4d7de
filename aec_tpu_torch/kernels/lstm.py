"""Kernel K9: DCCRN's grouped complex-LSTM recurrence as one CUDA launch, differentiable.

Replaces ``aec_tpu/kernels/pallas_lstm.py:88`` (``_grouped_lstm_fused_fwd``,
``pallas_call`` at ``:123``) and its custom VJP ``complex_lstm_scan_fused``
(``:160-184``, backward ``:341-350``). The kernel is ``csrc/lstm.cu``: one
persistent grid of co-resident CTAs, each owning a few (group, hidden unit)
pairs and their four gate columns of W_hh^T, held on chip across the time
loop (registers, then shared memory; from L2 each step only where a large
batch's h leaves the shared memory short), each group's CTAs waiting only
for their own group's h, exchanged in words that carry the step they are
for (the source's header has the reckoning).

Host side. :func:`grouped_plan` chooses each thread's column and k-slice
and where its quads of W lie; :func:`pack_grouped` builds that layout once
per weight tensor: it is cached keyed on each group's W_hh ``data_ptr()``
and ``_version`` (an entry holds the tensors, so no other tensor can take
their addresses while it lives), so an in-place change (``copy_``, an
optimizer step) makes the next call pack again. :func:`unpack_grouped` and
:func:`grouped_recurrence_modeled` model the layout and the kernel's
summation order in plain torch for the CPU tests.

As in JAX, the input projections of the four naive-complex paths and both
biases are one matmul outside the kernel (:func:`grouped_projection`): two
parameter groups (real, imag), each over 2B rows (the real and the imaginary
inputs). The kernel carries the recurrence from zero state, and the outputs
recombine as ``(r2r - i2i, i2r + r2i)``. Everything stays fp32 (JAX's TPU
kernel rounds h and W to bf16).

:class:`ComplexLstmScanFused` computes what the JAX custom VJP computes:
the forward through K9 (its plain version on the CPU), which, when a
gradient is wanted, also saves each step's activated gates and c; the
backward runs K9b (``kernels/lstm_bwd.py``) on them and forms the weight
gradients as plain products over the rows. JAX's backward is ``jax.vjp`` of
the scan, which XLA compiles into one loop on the device; the port's
counterpart of that loop is K9b, as K8b is the GRU's.
:func:`grouped_lstm_recurrence` is the kernel's wrapper (a CUDA tensor
launches K9 or raises, a CPU tensor takes the plain recurrence).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections import OrderedDict
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.ops.lstm import (
    GROUPS,
    complex_lstm_scan,
    grouped_lstm_recurrence_plain,
    grouped_projection,
    recombine,
    stacked,
)

_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
THREADS, WARPS, LANES = 512, 16, 32
REG_QUADS = 16  # float4 quads of W a thread holds in registers (csrc/lstm.cu kRegQuads)
CACHE_SIZE = 8  # packed W_hh kept: K9's and K9b's layouts of a few nets' layers


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("lstm"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' types on a build of ``csrc/lstm.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_lstm.argtypes = [p] * 5 + [i] * 12 + [p]
    lib.aec_lstm.restype = ctypes.c_int
    if lib.aec_lstm_reg_quads() != REG_QUADS:
        raise RuntimeError("csrc/lstm.cu holds another number of register quads than "
                           "kernels/lstm.py packs")
    return lib


def lstm_smem(rows: int, hp: int, units: int, cw: int, jsm: int) -> int:
    """Shared memory of one CTA, bytes (``csrc/lstm.cu`` lstm_smem): W's
    shared quads, the group's h, the gates' sums, c."""
    return 4 * (jsm * cw * THREADS * 4 + rows * hp + rows * WARPS * cw + rows * units)


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """Where K9 keeps W_hh^T. CTA c = g nchunk + chunk owns units [chunk U,
    chunk U + U) of group g, and its 4U gate columns (column gate U + j: that
    gate of unit chunk U + j) go to the warps, ``cw`` each: warp w sums
    columns w cw + i (i < cw), and its lane l holds their quads l + 32 j
    (j < ``npos``, the positions) of W_hh^T's column, k = 4 (l + 32 j) + e.
    A lane's quads of position j lie in registers for j < ``jreg``, in shared
    memory for j < ``jreg + jsm``, else they are read from L2 each step."""

    groups: int
    rows: int
    hidden: int
    hp: int  # H padded to whole quads
    units: int
    nchunk: int
    cw: int
    npos: int
    jreg: int
    jsm: int
    smem: int  # bytes of shared memory a CTA

    @property
    def ctas(self) -> int:
        return self.groups * self.nchunk

    @property
    def layout(self) -> tuple:
        """What the packed weights depend on."""
        return (self.units, self.nchunk, self.cw, self.npos)

    def split(self) -> dict[str, int]:
        """Bytes of W a CTA holds in registers and shared memory, and reads
        from L2 each step."""
        pos = self.cw * THREADS * 16
        return {"registers": self.jreg * pos, "shared": self.jsm * pos,
                "l2": (self.npos - self.jreg - self.jsm) * pos}


def grouped_plan(groups: int, rows: int, hidden: int, sms: int, smem_optin: int,
                 reg_quads: int = REG_QUADS) -> GroupedPlan:
    """K9's layout for G = ``groups`` recurrences of R = ``rows`` rows at H =
    ``hidden`` on a card of ``sms`` SMs giving a CTA ``smem_optin`` bytes of
    shared memory: about one CTA per SM (at most 64 units), the columns
    spread over the 16 warps (``cw`` a power of two), each lane's first
    ``reg_quads`` quads in registers, then as many in shared memory as fit
    beside h, the gates' sums and c (which must fit; the wrapper raises
    otherwise)."""
    units = min(-(-groups * hidden // sms), 64)
    cw = 1 << (-(-4 * units // WARPS) - 1).bit_length()
    nchunk = -(-hidden // units)
    hp = -(-hidden // 4) * 4
    npos = -(-hp // (4 * LANES))
    jreg = min(reg_quads // cw, npos)
    fixed = lstm_smem(rows, hp, units, cw, 0)
    jsm = max(0, min(npos - jreg, (smem_optin - fixed) // (cw * THREADS * 16)))
    return GroupedPlan(groups, rows, hidden, hp, units, nchunk, cw, npos, jreg, jsm,
                       lstm_smem(rows, hp, units, cw, jsm))


def pack_grouped(w_hh: torch.Tensor, plan: GroupedPlan) -> torch.Tensor:
    """``W_hh`` (G, 4H, H) -> (ctas, npos cw, 512, 4), as :class:`GroupedPlan`
    places it: quad j cw + i of thread w 32 + l of CTA g nchunk + chunk is
    ``W_hh[g][gate H + chunk U + u, 4 (l + 32 j) + e]``, e < 4, for column
    w cw + i = gate U + u; zero past H and for the columns past 4U. One op
    chain per weight tensor, never per call."""
    g, u, h, cw, npos = plan.groups, plan.units, plan.hidden, plan.cw, plan.npos
    w = F.pad(w_hh.reshape(g, 4, h, h), (0, 4 * LANES * npos - h, 0, plan.nchunk * u - h))
    w = w.reshape(g, 4, plan.nchunk, u, npos, LANES, 4).transpose(1, 2)
    w = w.reshape(g, plan.nchunk, 4 * u, npos, LANES, 4)
    w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, WARPS * cw - 4 * u))
    w = w.reshape(g, plan.nchunk, WARPS, cw, npos, LANES, 4).permute(0, 1, 4, 3, 2, 5, 6)
    return w.reshape(plan.ctas, npos * cw, THREADS, 4).contiguous()


def unpack_grouped(packed: torch.Tensor, plan: GroupedPlan) -> torch.Tensor:
    """The inverse of :func:`pack_grouped`: -> ``W_hh`` (G, 4H, H)."""
    g, u, h, cw, npos = plan.groups, plan.units, plan.hidden, plan.cw, plan.npos
    w = packed.reshape(g, plan.nchunk, npos, cw, WARPS, LANES, 4).permute(0, 1, 4, 3, 2, 5, 6)
    w = w.reshape(g, plan.nchunk, WARPS * cw, npos, LANES, 4)[:, :, :4 * u]
    w = w.reshape(g, plan.nchunk, 4, u, npos * LANES * 4).transpose(1, 2)
    return w.reshape(g, 4, plan.nchunk * u, -1)[:, :, :h, :h].reshape(g, 4 * h, h)


def grouped_recurrence_modeled(xp: torch.Tensor, packed: torch.Tensor,
                               plan: GroupedPlan) -> torch.Tensor:
    """K9's recurrence from the layout, in the kernel's summation order: each
    lane's dot over its quads l, l + 32, ... in k order (registers, then
    shared memory, then L2; fp32 products and sums here, FMAs in the
    kernel), the warp's 32 lanes summed as a tree whose first level pairs
    lanes l and l + 16, then the gates. A model for the CPU tests: xp
    (G, R, T, 4H) -> ys (G, R, T, H)."""
    g, r, t, _ = xp.shape
    u, h, cw, npos, nchunk = plan.units, plan.hidden, plan.cw, plan.npos, plan.nchunk
    w = packed.reshape(g, nchunk, npos, cw, WARPS, LANES, 4).permute(0, 1, 4, 3, 5, 2, 6)
    w = w.reshape(g, nchunk, 1, WARPS, cw, LANES, npos * 4)  # [g, chunk, -, w, i, l, k]
    k = npos * LANES * 4
    hs = xp.new_zeros((g, r, k))
    c = xp.new_zeros((g, r, nchunk * u))
    ys = []
    for i in range(t):
        hv = hs.reshape(g, r, npos, LANES, 4).transpose(2, 3).reshape(g, 1, r, 1, 1, LANES, -1)
        acc = xp.new_zeros((g, nchunk, r, WARPS, cw, LANES))
        for kk in range(npos * 4):  # registers, shared memory, L2: one k order
            acc = acc + hv[..., kk] * w[..., kk]
        for half in (16, 8, 4, 2, 1):
            acc = acc[..., :half] + acc[..., half:]
        pre = acc[..., 0].reshape(g, nchunk, r, WARPS * cw)[..., :4 * u]
        pre = pre.reshape(g, nchunk, r, 4, u).permute(0, 2, 3, 1, 4).reshape(g, r, 4, nchunk * u)
        x = F.pad(xp[:, :, i].reshape(g, r, 4, h), (0, nchunk * u - h))
        gi, gf, gg, go = (x[:, :, n] + pre[:, :, n] for n in range(4))
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        hn = torch.sigmoid(go) * torch.tanh(c)
        ys.append(hn[..., :h])
        hs = F.pad(hn[..., :h], (0, k - h))
    return torch.stack(ys, dim=2)


# ---------------------------------------------------------------- prepared once

_PACKED: OrderedDict = OrderedDict()


def clear_cache() -> None:
    """Forget every packed W_hh."""
    _PACKED.clear()


def packed_weights(w_hh: Sequence[torch.Tensor], plan, pack=pack_grouped) -> torch.Tensor:
    """``pack`` (:func:`pack_grouped`, or K9b's ``lstm_bwd.pack_backward``)
    of the groups' W_hh (each (4H, H), or one stacked (G, 4H, H)) at
    ``plan``, cached keyed on each tensor's ``data_ptr()`` and ``_version``,
    the packing and the plan's layout (the entry holds the tensors)."""
    key = (*((w.data_ptr(), w._version, tuple(w.shape), w.dtype, w.device) for w in w_hh),
           pack, plan.layout)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[0]
    stack = torch.stack([w.detach() for w in w_hh]) if w_hh[0].ndim == 2 else w_hh[0].detach()
    _PACKED[key] = (pack(stack, plan), list(w_hh))
    while len(_PACKED) > CACHE_SIZE:
        _PACKED.popitem(last=False)
    return _PACKED[key][0]


# ---------------------------------------------------------------- the wrapper


def _groups(w_hh) -> list[torch.Tensor]:
    return [w_hh] if isinstance(w_hh, torch.Tensor) else list(w_hh)


def _check(xp: torch.Tensor, w_hh: list[torch.Tensor]) -> None:
    if xp.device.type != "cuda" or any(w.device != xp.device for w in w_hh):
        raise ValueError(f"xp and w_hh must be on one CUDA device, got {xp.device}, "
                         f"{[str(w.device) for w in w_hh]}")
    if xp.dtype != torch.float32 or any(w.dtype != torch.float32 for w in w_hh):
        raise TypeError(f"xp and w_hh must be float32, got {xp.dtype}, "
                        f"{[w.dtype for w in w_hh]}")
    shapes = [tuple(w.shape) for w in w_hh]
    if xp.ndim != 4 or not (len(w_hh) == 1 and len(shapes[0]) == 3
                            or all(len(s) == 2 for s in shapes)):
        raise ValueError(f"want xp (G, R, T, 4H) and w_hh (G, 4H, H) or G of (4H, H), got "
                         f"{tuple(xp.shape)}, {shapes}")
    g, _, steps, h4 = xp.shape
    hidden = h4 // 4
    want = [(g, h4, hidden)] if len(shapes[0]) == 3 else [(h4, hidden)] * g
    if h4 != 4 * hidden or shapes != want or steps < 1:
        raise ValueError(f"want xp (G, R, T >= 1, 4H) and w_hh (G, 4H, H) or G of (4H, H), got "
                         f"{tuple(xp.shape)}, {shapes}")
    if not xp.is_contiguous():
        raise ValueError("xp must be contiguous")


def card_plan(groups: int, rows: int, hidden: int, device: torch.device) -> GroupedPlan:
    """:func:`grouped_plan` for this card."""
    props = torch.cuda.get_device_properties(device)
    return grouped_plan(groups, rows, hidden, props.multi_processor_count,
                        props.shared_memory_per_block_optin)


def grouped_lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor | Sequence[torch.Tensor],
                            save: bool = False):
    """The grouped LSTM recurrence over the hoisted projection ``xp``
    (G, R, T, 4H) (:func:`grouped_projection`) with ``w_hh`` (G, 4H, H), or
    the G groups' (4H, H) tensors -> ys (G, R, T, H), from zero state; with
    ``save`` also each step's activated gates and c (G, R, T, 5H) that
    K9b (``kernels/lstm_bwd.py``) takes, ys the same bits.

    A CUDA tensor launches K9 (or raises: not fp32, not contiguous, T = 0, a
    group's h that one CTA's shared memory cannot hold, a grid the card
    cannot hold co-resident), with W_hh packed at its first call and cached;
    a CPU tensor takes the plain recurrence.
    """
    ws = _groups(w_hh)
    if xp.device.type == "cpu":
        return grouped_lstm_recurrence_plain(xp, ws[0] if len(ws) == 1 else torch.stack(ws),
                                             save)
    _check(xp, ws)
    g, r, t, h4 = xp.shape
    plan = card_plan(g, r, h4 // 4, xp.device)
    _build.check_smem(plan.smem, xp.device, "the grouped LSTM kernel (a group's h in every CTA)")
    saved = xp.new_empty((g, r, t, 5 * h4 // 4)) if save else None
    ys = launch(_lib(), plan, xp, packed_weights(ws, plan), xp.device.index,
                _build.stream_of(xp), saved)
    grouped_lstm_recurrence.launches += 1
    return (ys, saved) if save else ys


def launch(lib, plan: GroupedPlan, xp: torch.Tensor, packed: torch.Tensor, dev: int,
           stream, saved: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of ``lib``'s K9 at ``plan`` on checked inputs -> ys,
    writing the gates into ``saved`` where one is given."""
    g, r, t, h4 = xp.shape
    hidden = h4 // 4
    hbuf = torch.zeros(2 * (2 * g * r * plan.hp + g), dtype=torch.int32, device=xp.device)
    ys = xp.new_empty((g, r, t, hidden))
    err = lib.aec_lstm(
        _build.ptr(xp), _build.ptr(packed), _build.ptr(hbuf), _build.ptr(ys),
        None if saved is None else _build.ptr(saved), g, r, t, hidden, plan.hp, plan.units,
        plan.nchunk, plan.cw, plan.npos, plan.jreg, plan.jsm, dev, stream,
    )
    _build.check(err, "lstm")
    return ys


grouped_lstm_recurrence.launches = 0


def _params(flat) -> dict:
    """The 8 tensors in (real, imag) x (w_ih, w_hh, b_ih, b_hh) order -> the
    complex-LSTM params dict."""
    return {g: dict(zip(_KEYS, flat[4 * j: 4 * j + 4])) for j, g in enumerate(GROUPS)}


def _flat(params: dict) -> list[torch.Tensor]:
    return [params[g][k] for g in GROUPS for k in _KEYS]


class ComplexLstmScanFused(torch.autograd.Function):
    """``(real, imag, save, *the 8 parameters) -> (real_out, imag_out)``:
    forward through K9 (plain on the CPU), saving the gates where ``save``
    (autograd records and some input wants a gradient: every forward that
    has a backward); backward through K9b (plain on the CPU) and the weight
    gradients as products over the 2 x 2B x T rows."""

    @staticmethod
    def forward(ctx, real, imag, save, *weights):
        params = _params(weights)
        x2 = torch.cat([real, imag], dim=0)
        w_hh = [params[g]["w_hh"] for g in GROUPS]
        xp = grouped_projection(params, x2).contiguous()
        if save:
            ys, saved = grouped_lstm_recurrence(xp, w_hh, save=True)
            ctx.save_for_backward(x2, ys, saved, *weights)
        else:
            ys = grouped_lstm_recurrence(xp, w_hh)
        return recombine(ys, real.shape[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g_real, g_imag):
        from aec_tpu_torch.kernels.lstm_bwd import lstm_backward

        x2, ys, saved, *weights = ctx.saved_tensors
        params = _params(weights)
        g, r, t, hidden = ys.shape
        b = r // 2
        # recombine's signs: real_out = ys[0, :B] - ys[1, B:], imag_out = ys[0, B:] + ys[1, :B]
        g_ys = torch.stack([torch.cat([g_real, g_imag]), torch.cat([g_imag, -g_real])])
        dxp = lstm_backward(g_ys.unsqueeze(3), saved.unsqueeze(3),
                            [params[k]["w_hh"] for k in GROUPS]).squeeze(3)
        rows = dxp.reshape(g, r * t, 4 * hidden)
        need = ctx.needs_input_grad
        d_x2 = (torch.bmm(rows, stacked(params, "w_ih")).sum(0).reshape(r, t, -1)
                if need[0] or need[1] else None)
        d_w_ih = rows.transpose(1, 2) @ x2.reshape(r * t, -1)
        d_b = rows.sum(1)
        h_prev = F.pad(ys, (0, 0, 1, 0))[:, :, :t].reshape(g, r * t, hidden)
        d_w_hh = rows.transpose(1, 2) @ h_prev
        grads = [d_w_ih, d_w_hh, d_b, d_b]  # _KEYS order; both biases sit in xp alike
        flat = [grads[k][j] for j in range(len(GROUPS)) for k in range(len(_KEYS))]
        return (d_x2[:b] if need[0] else None, d_x2[b:] if need[1] else None, None,
                *(d if n else None for d, n in zip(flat, need[3:])))


def complex_lstm_scan_fused(params: dict, real: torch.Tensor,
                            imag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused grouped complex LSTM: ``([B, T, I], [B, T, I]) -> ([B, T, H],
    [B, T, H])``, differentiable in both inputs and the 8 parameters. K9
    saves the gates for K9b only where autograd records and some input
    needs a gradient."""
    weights = _flat(params)
    save = torch.is_grad_enabled() and any(a.requires_grad for a in (real, imag, *weights))
    return ComplexLstmScanFused.apply(real, imag, save, *weights)


def complex_lstm_scan_fused_plain(params: dict, real: torch.Tensor,
                                  imag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`complex_lstm_scan_fused`'s forward: the plain
    grouped scan, ``complex_lstm_scan(fused=False)`` (the hoisted projection,
    K9's arithmetic in torch, the recombination)."""
    return complex_lstm_scan(params, real, imag, fused=False)
