"""Kernel K10: the int8 LSTM recurrence as one CUDA launch (inference only).

Replaces ``aec_tpu/kernels/pallas_lstm.py:237`` (``lstm_int8_fused``,
``pallas_call`` at ``:299``). The kernel is ``csrc/lstm_int8.cu``: one
persistent grid of co-resident CTAs, each owning a few hidden units and
their 4 gate rows of W_hh's int8 codes, held on chip across the time loop
(the first chunks of each row in registers, the next in shared memory, the
rest read from L2 each step), ``__dp4a`` dots against h's codes, and h's
codes exchanged in words that carry the step they are for, each CTA reading
them as soon as they are written (the source's header has the reckoning). It repeats the plain loop's arithmetic operation for
operation (``ops.lstm.lstm_int8_recurrence_plain``), so the two agree to
the last bit unless a transcendental differs by an ulp.

Host side. :func:`int8_plan` chooses where each chunk of 16 codes lies and
:func:`pack_int8` builds that layout from the codes, once per codes tensor:
the layout is cached keyed on its ``data_ptr()`` and ``_version`` (an entry
holds the tensor, so no other tensor can take its address while it lives),
and :func:`quantized` caches ``lstm_scan``'s quantization of ``W_hh`` the
same way, so an ATT-CCRN utterance neither quantizes 268 MB of fp32 nor
packs 67 MB of codes; an in-place change (``copy_``, an optimizer step)
makes the next call build them again. :func:`unpack_int8` and
:func:`lstm_int8_recurrence_modeled` model the layout in plain torch for
the CPU tests.

Unlike JAX's kernel it takes any initial state, any B and any H. The
rounding sites have no gradient, so there is no autograd Function (JAX's
kernel has no VJP either). :func:`lstm_int8_recurrence` is the kernel's
wrapper (a CUDA tensor launches K10 or raises, a CPU tensor takes the plain
loop).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections import OrderedDict

import torch
import torch.nn.functional as F

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.ops.lstm import lstm_gates, lstm_int8_recurrence_plain, quantize_rows_int8

THREADS, WARPS, LANES = 512, 16, 32
REG_QUADS = 16  # 16-code chunks a thread holds in registers (csrc/lstm_int8.cu kRegQuads)
MAX_RPW = 16  # the largest row-slot count a warp keeps in registers (the kernel's instantiations)
CACHE_SIZE = 4


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("lstm_int8"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' types on a build of ``csrc/lstm_int8.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_lstm_int8.argtypes = [p] * 9 + [i] * 11 + [p]
    lib.aec_lstm_int8.restype = ctypes.c_int
    if lib.aec_lstm_int8_reg_quads() != REG_QUADS:
        raise RuntimeError("csrc/lstm_int8.cu holds another number of register chunks than "
                           "kernels/lstm_int8.py packs")
    return lib


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def int8_smem(b: int, hp: int, units: int, rs: int, ksm: int) -> int:
    """Shared memory of one CTA, bytes (``csrc/lstm_int8.cu`` int8_smem):
    the shared chunks, h's codes, the int32 sums, the cells' xp, c, the
    rows' scales and b_hh."""
    return (rs * ksm * 16 + b * hp + 2 * _round16(b * 4 * units * 4) + _round16(b * units * 4)
            + 2 * _round16(4 * units * 4))


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """Where K10 keeps W_hh's codes. CTA c owns units [c U, c U + U); its
    local row rl < 4U is gate rl // U of unit c U + rl % U, and rows up to
    ``rs`` are zero. Chunk j (codes 16 j .. 16 j + 15) of a row lies in
    registers for j < ``kreg``, in shared memory for j < ``kreg + ksm``, else
    in L2. In registers, warp w owns row slots rl = rr 16 + w (rr < ``rpw``)
    and lane l chunks j = c 32 + l (c < ``cr``); ``rpw`` 0 keeps no codes in
    registers."""

    hidden: int
    hp: int  # H padded to whole chunks
    units: int
    ctas: int
    rpw: int
    rs: int  # rows a CTA holds, 16 rpw (or 4U rounded up to 16 when rpw is 0)
    cr: int
    kreg: int
    nrest: int  # chunks a row outside the registers
    ksm: int
    smem: int  # bytes of shared memory a CTA

    @property
    def nk16(self) -> int:
        return self.hp // 16

    def split(self) -> dict[str, int]:
        """Bytes of codes a CTA holds in registers and shared memory, and
        reads from L2 each step."""
        rows = self.rs
        return {"registers": rows * self.kreg * 16, "shared": rows * self.ksm * 16,
                "l2": rows * (self.nrest - self.ksm) * 16}


def int8_plan(hidden: int, batch: int, sms: int, smem_optin: int,
              reg_quads: int = REG_QUADS) -> Int8Plan:
    """K10's layout at H = ``hidden`` and B = ``batch`` on a card of ``sms``
    SMs giving a CTA ``smem_optin`` bytes of shared memory: about one CTA
    per SM (U a multiple of 4, so that a CTA writes whole words of h's
    codes), the row slots a warp needs rounded up to a power of two (up to
    ``MAX_RPW``; more take the path without register codes), the register
    chunks first, then as many shared chunks as fit beside h's codes (which
    must fit; the wrapper raises otherwise)."""
    units = 4 * -(-hidden // (4 * sms))
    ctas = -(-hidden // units)
    hp = _round16(hidden)
    slots = -(-4 * units // WARPS)
    rpw = 1 << (slots - 1).bit_length()
    if rpw > min(MAX_RPW, reg_quads):
        rpw, rs, cr = 0, WARPS * slots, 0
    else:
        rs, cr = WARPS * rpw, reg_quads // rpw
    kreg = min(LANES * cr, hp // 16)
    nrest = hp // 16 - kreg
    fixed = int8_smem(batch, hp, units, rs, 0)
    ksm = max(0, min(nrest, (smem_optin - fixed) // (rs * 16)))
    return Int8Plan(hidden, hp, units, ctas, rpw, rs, cr, kreg, nrest, ksm,
                    int8_smem(batch, hp, units, rs, ksm))


def _cta_rows(plan: Int8Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """(ctas, rs) global row of each CTA row, and whether it exists."""
    u, h = plan.units, plan.hidden
    rl = torch.arange(plan.rs)
    unit = torch.arange(plan.ctas)[:, None] * u + (rl % u)[None, :]
    valid = (rl < 4 * u)[None, :] & (unit < h)
    return (rl // u)[None, :] * h + unit, valid


def pack_int8(w_q: torch.Tensor, plan: Int8Plan,
              reg_quads: int = REG_QUADS) -> tuple[torch.Tensor, torch.Tensor]:
    """W_hh's codes (4H, H) -> (registers (ctas, reg_quads, 512, 16),
    rest (ctas, rs, nrest, 16)), int8, as :class:`Int8Plan` places them:
    register chunk i = rr cr + c of thread w 32 + l is chunk c 32 + l of
    row slot rr 16 + w; the rest of a row follows from chunk ``kreg``, its
    first ``ksm`` chunks for shared memory, the others for L2. One op chain
    per codes tensor, never per call."""
    h4 = w_q.shape[0]
    codes = F.pad(w_q, (0, plan.hp - plan.hidden)).reshape(h4, plan.nk16, 16)
    codes = torch.cat([codes, codes.new_zeros((1, plan.nk16, 16))])
    row, valid = _cta_rows(plan)
    rows = codes[torch.where(valid, row, h4).to(w_q.device)]  # (ctas, rs, nk16, 16)
    rest = rows[:, :, plan.kreg:].contiguous()
    ctas = plan.ctas
    if plan.rpw == 0:
        return w_q.new_zeros((ctas, 0, THREADS, 16)), rest
    reg = F.pad(rows[:, :, :plan.kreg], (0, 0, 0, LANES * plan.cr - plan.kreg))
    reg = reg.reshape(ctas, plan.rpw, WARPS, plan.cr, LANES, 16).permute(0, 1, 3, 2, 4, 5)
    reg = reg.reshape(ctas, plan.rpw * plan.cr, THREADS, 16)
    return F.pad(reg, (0, 0, 0, 0, 0, reg_quads - plan.rpw * plan.cr)).contiguous(), rest


def unpack_int8(reg: torch.Tensor, rest: torch.Tensor, plan: Int8Plan) -> torch.Tensor:
    """The inverse of :func:`pack_int8`: -> W_hh's codes (4H, H)."""
    ctas, h = plan.ctas, plan.hidden
    if plan.rpw:
        r = reg[:, :plan.rpw * plan.cr].reshape(ctas, plan.rpw, plan.cr, WARPS, LANES, 16)
        r = r.permute(0, 1, 3, 2, 4, 5).reshape(ctas, plan.rs, LANES * plan.cr, 16)
        rows = torch.cat([r[:, :, :plan.kreg], rest], dim=2)
    else:
        rows = rest
    row, valid = (a.to(rows.device) for a in _cta_rows(plan))
    out = rows.new_zeros((4 * h, plan.nk16, 16))
    out[row[valid]] = rows[valid]
    return out.reshape(4 * h, plan.hp)[:, :h]


def int8_dots_modeled(h_q: torch.Tensor, reg: torch.Tensor, rest: torch.Tensor,
                      plan: Int8Plan) -> torch.Tensor:
    """The exact sums ``h_q @ w_q.T`` (B, 4H) of h's codes ``h_q`` (B, H)
    from the layout, part by part as the kernel forms them: each row's
    register chunks, shared chunks and L2 chunks (int64 here, int32 in the
    kernel; exact either way, so the order of the terms does not matter)."""
    b = h_q.shape[0]
    hq = F.pad(h_q.to(torch.int64), (0, plan.hp - plan.hidden)).reshape(b, plan.nk16, 16)
    ctas, rs = plan.ctas, plan.rs
    parts = []
    if plan.rpw:
        r = reg[:, :plan.rpw * plan.cr].reshape(ctas, plan.rpw, plan.cr, WARPS, LANES, 16)
        r = r.permute(0, 1, 3, 2, 4, 5).reshape(ctas, rs, LANES * plan.cr, 16)[:, :, :plan.kreg]
        parts.append((r, hq[:, :plan.kreg]))
    k1 = plan.kreg + plan.ksm
    parts.append((rest[:, :, :plan.ksm], hq[:, plan.kreg:k1]))
    parts.append((rest[:, :, plan.ksm:], hq[:, k1:]))
    acc = hq.new_zeros((b, ctas, rs))
    for w, hv in parts:
        acc += torch.einsum("crjs,bjs->bcr", w.to(torch.int64), hv)
    row, valid = (a.to(hq.device) for a in _cta_rows(plan))
    out = hq.new_zeros((b, 4 * plan.hidden))
    out[:, row[valid]] = acc[:, valid]
    return out


def lstm_int8_recurrence_modeled(
    xp: torch.Tensor, reg: torch.Tensor, rest: torch.Tensor, plan: Int8Plan,
    out_scale: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """K10's recurrence with its dots from the layout (:func:`int8_dots_modeled`)
    and the plain loop's gates: a model for the CPU tests."""
    h, c, hs = h0, c0, []
    for i in range(xp.shape[1]):
        h_q = torch.round(torch.clamp(h * 127.0, -127.0, 127.0)).to(torch.int64)
        acc = int8_dots_modeled(h_q, reg, rest, plan).to(xp.dtype)
        h, c = lstm_gates(xp[:, i] + acc * out_scale + b_hh, c)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)


# ---------------------------------------------------------------- prepared once

_LAYOUTS: OrderedDict = OrderedDict()
_CODES: OrderedDict = OrderedDict()


def clear_cache() -> None:
    """Forget every prepared layout and quantization."""
    _LAYOUTS.clear()
    _CODES.clear()


def _cached(cache: OrderedDict, key, build):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    cache[key] = out = build()
    while len(cache) > CACHE_SIZE:
        cache.popitem(last=False)
    return out


def _key(t: torch.Tensor, *extra) -> tuple:
    return (t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device, *extra)


def quantized(w_hh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows_int8(w_hh)`` as (codes, row scale / 127), cached per
    weight tensor (keyed on its ``data_ptr()`` and ``_version``; the entry
    holds it). The card's int8 route of ``ops.lstm.lstm_scan`` takes it, so
    the codes keep their address from call to call and their layout stays
    cached too."""
    def build():
        w_q, scale = quantize_rows_int8(w_hh.detach())
        return w_q, scale / 127.0, w_hh

    w_q, out_scale, _ = _cached(_CODES, _key(w_hh), build)
    return w_q, out_scale


def _layout(w_q: torch.Tensor, plan: Int8Plan) -> tuple[torch.Tensor, torch.Tensor]:
    layout_key = (plan.units, plan.rpw, plan.rs, plan.kreg)
    reg, rest, _ = _cached(_LAYOUTS, _key(w_q, layout_key),
                           lambda: (*pack_int8(w_q, plan), w_q))
    return reg, rest


# ---------------------------------------------------------------- the wrapper


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


def card_plan(hidden: int, batch: int, device: torch.device) -> Int8Plan:
    """:func:`int8_plan` for this card."""
    props = torch.cuda.get_device_properties(device)
    return int8_plan(hidden, batch, props.multi_processor_count,
                     props.shared_memory_per_block_optin)


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
    cannot hold, a grid the card cannot hold co-resident. ``w_q``'s layout
    is built at its first call and cached. A CPU tensor takes the plain
    loop.
    """
    if xp.device.type == "cpu":
        return lstm_int8_recurrence_plain(xp, w_q, out_scale, b_hh, h0, c0)
    _check(xp, w_q, out_scale, b_hh, h0, c0)
    b, t, h4 = xp.shape
    hidden, dev = h4 // 4, xp.device.index
    if t == 0:
        return xp.new_zeros((b, 0, hidden)), (h0, c0)
    plan = card_plan(hidden, b, xp.device)
    _build.check_smem(plan.smem, xp.device,
                      "the int8 LSTM kernel (the codes of h for every row in every CTA)")
    out = launch(_lib(), plan, xp, w_q, out_scale, b_hh, h0, c0, dev, _build.stream_of(xp))
    lstm_int8_recurrence.launches += 1
    return out


def launch(lib, plan: Int8Plan, xp, w_q, out_scale, b_hh, h0, c0, dev: int, stream):
    """One launch of ``lib``'s K10 at ``plan`` on checked inputs (T >= 1),
    with ``w_q``'s cached layout: -> (ys, (h_T, c_T))."""
    b, t, h4 = xp.shape
    hidden = h4 // 4
    reg, rest = _layout(w_q, plan)
    codes = w_q.new_zeros((b, plan.hp))
    codes[:, :hidden] = torch.round(torch.clamp(h0 * 127.0, -127.0, 127.0)).to(torch.int8)
    hq = torch.zeros((2, b, plan.hp // 4, 2), dtype=torch.int32, device=xp.device)
    hq[0, :, :, 0] = codes.view(torch.int32)  # h0's words: 4 codes, for step 0
    ys = xp.new_empty((b, t, hidden))
    c_t = xp.new_empty((b, hidden))
    err = lib.aec_lstm_int8(
        _build.ptr(xp), _build.ptr(reg), _build.ptr(rest), _build.ptr(out_scale),
        _build.ptr(b_hh), _build.ptr(c0), _build.ptr(hq), _build.ptr(ys), _build.ptr(c_t),
        b, t, hidden, plan.hp, plan.units, plan.rpw, plan.rs, plan.kreg, plan.nrest, plan.ksm,
        dev, stream,
    )
    _build.check(err, "lstm_int8")
    return ys, (ys[:, -1], c_t)


lstm_int8_recurrence.launches = 0
