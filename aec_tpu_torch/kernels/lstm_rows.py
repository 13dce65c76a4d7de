"""Kernel K13: an LSTM layer over many independent rows, forward and backward.

FullSubNet's sub band runs one LSTM over every (sample, bin) row: at its
published widths 2,048 rows (16 samples x 128 bins under drop band) at H =
384 in training, B x 257 at inference. That is no regime of K9 / K9b
(``kernels/lstm.py``, ``kernels/lstm_bwd.py``), which spread W_hh's units
over a grid of CTAs for a few rows and exchange h every step. The rows
never meet, so ``csrc/lstm_rows.cu`` gives each CTA 16 rows and every unit
and lets it march through time alone, W_hh streamed from L2 through shared
memory in tiles each step (the source's header has the design and the
reckoning, :mod:`aec_tpu_torch.kernels.lstm_rows_costs` the bound).

Host side. :func:`pack_forward` / :func:`pack_backward` lay W_hh out as the
kernels read it (cached per weight tensor by ``kernels/lstm.py``'s
:func:`~aec_tpu_torch.kernels.lstm.packed_weights`, keyed on ``data_ptr()``
and ``_version``); :func:`rows_recurrence` and :func:`rows_backward` are the
wrappers (a CUDA tensor launches K13 or raises, a CPU tensor takes K9's and
K9b's plain versions, which compute the same functions).

:class:`LstmLayerFused` is one LSTM layer as an autograd Function: the
input projection as one product over all frames, the recurrence on a
kernel (saving the gates where a backward follows), its backward on the
matching kernel, and the weight gradients as products over all rows. The
route is by rows (:func:`layer_route`): K13 for many rows, K9 / K9b (one
group) for few, where a step's latency, not its work, is the bound.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.kernels.lstm import packed_weights
from aec_tpu_torch.ops.lstm import grouped_lstm_recurrence_plain
from aec_tpu_torch.utils import profiling

ROWS_CTA = 16  # rows a CTA (csrc/lstm_rows.cu kRows)
LANES = 128  # unit lanes a CTA (kLanes): a thread holds units l + 128 j
TILE_K = 8  # the forward's k-values a tile of W (kKt)
FEW_ROWS = 32  # at most this many rows take K9 / K9b (layer_route)
# row-steps a block of the weight gradients' sums (:func:`rows_product`): one
# fp32 accumulation over the sub band's 1.03 M row-steps drifts from the
# exact sum by ~1e-4 of a leaf's norm; blocks of whole rows, summed after
SUM_BLOCK = 16384


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("lstm_rows"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' types on a build of ``csrc/lstm_rows.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_lstm_rows.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.aec_lstm_rows.restype = ctypes.c_int
    lib.aec_lstm_rows_bwd.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.aec_lstm_rows_bwd.restype = ctypes.c_int
    got = tuple(lib.aec_lstm_rows_consts(k) for k in range(5))
    if got != (ROWS_CTA, LANES, TILE_K, tile_quads(LANES), tile_quads(4 * LANES)):
        raise RuntimeError(f"csrc/lstm_rows.cu holds other constants {got} than "
                           "kernels/lstm_rows.py packs by")
    return lib


def tile_quads(hidden: int) -> int:
    """The backward's quads of W_hh's rows a tile (csrc kBwdQuads): 8, or 4
    past H = 384, where two tiles and 16 rows of dxp would not fit."""
    return 8 if -(-hidden // LANES) <= 3 else 4


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """K13's layout for width ``hidden``: ``upt`` units a thread (128 lanes),
    W_hh^T's k padded to ``kp`` (whole forward tiles), W_hh's 4H rows to
    ``4 kq`` (whole backward tiles)."""

    hidden: int
    upt: int
    kp: int
    kq: int

    @property
    def units(self) -> int:
        return LANES * self.upt

    @property
    def layout(self) -> tuple:
        return ("rows", self.hidden, self.kp, self.kq)

    @property
    def name(self) -> str:
        """The plan's key in the launch counters."""
        return f"r{ROWS_CTA}u{self.upt}"

    def smem(self, backward: bool) -> int:
        """Bytes of shared memory a CTA (``csrc/lstm_rows.cu`` fwd_smem,
        bwd_smem): two tiles of W, and h's 16 rows (forward) or dxp's
        (backward)."""
        if backward:
            return 16 * 2 * tile_quads(self.hidden) * self.units + 4 * ROWS_CTA * 4 * self.kq
        return 16 * 2 * TILE_K * self.units + 4 * ROWS_CTA * self.kp


def rows_plan(hidden: int) -> RowsPlan:
    if not 1 <= hidden <= 4 * LANES:
        raise ValueError(f"K13 takes 1 <= H <= {4 * LANES}, got {hidden}")
    q = tile_quads(hidden)
    return RowsPlan(hidden, -(-hidden // LANES), -(-hidden // TILE_K) * TILE_K,
                    -(-hidden // q) * q)


def pack_forward(w_hh: torch.Tensor, plan: RowsPlan) -> torch.Tensor:
    """W_hh (1, 4H, H) -> (kp, 128 upt, 4): ``[k][u][g] = W_hh[g H + u, k]``,
    zero past H in u and k."""
    h = plan.hidden
    w = w_hh.reshape(4, h, h).permute(2, 1, 0)  # [k, u, g]
    return F.pad(w, (0, 0, 0, plan.units - h, 0, plan.kp - h)).contiguous()


def pack_backward(w_hh: torch.Tensor, plan: RowsPlan) -> torch.Tensor:
    """W_hh (1, 4H, H) -> (kq, 128 upt, 4): ``[q][u][e] = W_hh[4 q + e, u]``,
    zero past 4H rows and past H in u."""
    h = plan.hidden
    w = F.pad(w_hh.reshape(4 * h, h), (0, plan.units - h, 0, 4 * plan.kq - 4 * h))
    return w.reshape(plan.kq, 4, plan.units).transpose(1, 2).contiguous()


def _check(what: str, tensors: list, shapes: list) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError(f"{what}: every tensor on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what}: float32 tensors, got {[t.dtype for t in tensors]}")
    got = [tuple(t.shape) for t in tensors]
    if got != shapes:
        raise ValueError(f"{what}: want shapes {shapes}, got {got}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: contiguous tensors")


def rows_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, save: bool = False):
    """The recurrence over the hoisted projection ``xp`` (R, T, 4H) with
    ``w_hh`` (4H, H) -> ys (R, T, H) from zero state; with ``save`` also each
    step's activated gates and c (R, T, 5H), what :func:`rows_backward`
    takes. A CUDA tensor launches K13 (or raises); a CPU tensor takes K9's
    plain version (the same function, the same layout)."""
    if xp.device.type == "cpu":
        out = grouped_lstm_recurrence_plain(xp[None], w_hh[None], save)
        return (out[0][0], out[1][0]) if save else out[0]
    r, t, h4 = xp.shape
    h = h4 // 4
    _check("K13", [xp, w_hh], [(r, t, h4), (h4, h)])
    plan = rows_plan(h)
    _build.check_smem(plan.smem(False), xp.device, "the many-row LSTM kernel (two tiles of W, "
                      "16 rows of h)")
    ys = xp.new_empty((r, t, h))
    saved = xp.new_empty((r, t, 5 * h)) if save else None
    err = _lib().aec_lstm_rows(
        _build.ptr(xp), _build.ptr(packed_weights([w_hh], plan, pack_forward)), _build.ptr(ys),
        None if saved is None else _build.ptr(saved), r, t, h, plan.kp, xp.device.index,
        _build.stream_of(xp))
    _build.check(err, "lstm_rows")
    key = plan.name + (".save" if save else "")
    rows_recurrence.launches += 1
    rows_recurrence.steps[key] = rows_recurrence.steps.get(key, 0) + 1
    return (ys, saved) if save else ys


rows_recurrence.launches = 0
rows_recurrence.steps = {}


def rows_backward(g_ys: torch.Tensor, saved: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The recurrence's VJP: ``g_ys`` (R, T, H), ``saved`` (R, T, 5H) from
    :func:`rows_recurrence` with ``save``, ``w_hh`` (4H, H) -> dxp (R, T,
    4H), the gradient of each step's pre-activations. A CUDA tensor
    launches K13's backward (or raises); a CPU tensor takes K9b's plain
    version."""
    if g_ys.device.type == "cpu":
        from aec_tpu_torch.kernels.lstm_bwd import lstm_backward_plain

        return lstm_backward_plain(g_ys[None, :, :, None], saved[None, :, :, None],
                                   w_hh[None])[0, :, :, 0]
    r, t, h = g_ys.shape
    _check("K13's backward", [g_ys, saved, w_hh], [(r, t, h), (r, t, 5 * h), (4 * h, h)])
    plan = rows_plan(h)
    _build.check_smem(plan.smem(True), g_ys.device, "the many-row LSTM backward (two tiles of W, "
                      "16 rows of dxp)")
    dxp = g_ys.new_empty((r, t, 4 * h))
    err = _lib().aec_lstm_rows_bwd(
        _build.ptr(g_ys), _build.ptr(saved),
        _build.ptr(packed_weights([w_hh], plan, pack_backward)), _build.ptr(dxp), r, t, h,
        plan.kq, g_ys.device.index, _build.stream_of(g_ys))
    _build.check(err, "lstm_rows_bwd")
    rows_backward.launches += 1
    rows_backward.steps[plan.name] = rows_backward.steps.get(plan.name, 0) + 1
    return dxp


rows_backward.launches = 0
rows_backward.steps = {}


def layer_route(rows: int) -> str:
    """"grouped" (K9 / K9b as one group: a few rows, a step bound by its
    latency) for at most :data:`FEW_ROWS` rows, else "rows" (K13)."""
    return "grouped" if rows <= FEW_ROWS else "rows"


def _recurrence(xp: torch.Tensor, w_hh: torch.Tensor, save: bool):
    if layer_route(xp.shape[0]) == "rows" or xp.device.type == "cpu":
        return rows_recurrence(xp, w_hh, save)
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence

    out = grouped_lstm_recurrence(xp[None], [w_hh], save)
    return (out[0][0], out[1][0]) if save else out[0]


def _backward(g_ys: torch.Tensor, saved: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    if layer_route(g_ys.shape[0]) == "rows" or g_ys.device.type == "cpu":
        return rows_backward(g_ys, saved, w_hh)
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward

    return lstm_backward(g_ys[None, :, :, None], saved[None, :, :, None], [w_hh])[0, :, :, 0]


def rows_product(a: torch.Tensor, b: torch.Tensor, rows: int) -> torch.Tensor:
    """``a^T b`` over the ``rows`` x T row-steps of a (R T, P) and b (R T,
    Q), row-major, summed in blocks of whole rows of at most
    :data:`SUM_BLOCK` row-steps (one batched product), then over the
    blocks."""
    per = max(1, SUM_BLOCK // (a.shape[0] // rows))  # rows a block
    blocks = rows // per
    if blocks <= 1:
        return a.T @ b
    n = blocks * per * (a.shape[0] // rows)
    out = torch.bmm(a[:n].reshape(blocks, -1, a.shape[1]).transpose(1, 2),
                    b[:n].reshape(blocks, -1, b.shape[1])).sum(0)
    return out + a[n:].T @ b[n:] if n < a.shape[0] else out


class LstmLayerFused(torch.autograd.Function):
    """``(x, save, span, w_ih, w_hh, b_ih, b_hh) -> ys``: x (R, T, I) -> ys
    (R, T, H) from zero state. The forward hoists x W_ih^T + b_ih + b_hh into
    one product and runs the recurrence on its kernel (:func:`layer_route`;
    the plain versions on the CPU), saving the gates where ``save``; the
    backward runs the matching backward kernel inside the program span
    ``span`` and forms the gradients of x and the weights as products over
    the R T row-steps (the weights' in blocks, :func:`rows_product`)."""

    @staticmethod
    def forward(ctx, x, save, span, w_ih, w_hh, b_ih, b_hh):
        r, t, _ = x.shape
        xp = torch.addmm(b_ih + b_hh, x.reshape(r * t, -1), w_ih.T).reshape(r, t, -1)
        if not save:
            return _recurrence(xp, w_hh, False)
        ys, saved = _recurrence(xp, w_hh, True)
        ctx.span = span
        ctx.save_for_backward(x, ys, saved, w_ih, w_hh)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g_ys):
        x, ys, saved, w_ih, w_hh = ctx.saved_tensors
        r, t, h = ys.shape
        with profiling.span(ctx.span):
            dxp = _backward(g_ys.contiguous(), saved, w_hh).reshape(r * t, 4 * h)
            need = ctx.needs_input_grad
            dx = (dxp @ w_ih).reshape(r, t, -1) if need[0] else None
            d_w_ih = rows_product(dxp, x.reshape(r * t, -1), r)
            d_b = dxp.sum(0)
            d_w_hh = rows_product(dxp, F.pad(ys, (0, 0, 1, 0))[:, :t].reshape(r * t, h), r)
        return dx, None, None, d_w_ih, d_w_hh, d_b, d_b


def lstm_layer(params: dict, x: torch.Tensor, span: str = "lstm.layer") -> torch.Tensor:
    """One LSTM layer (torch layout ``params``: w_ih, w_hh, b_ih, b_hh) over
    x (R, T, I) -> ys (R, T, H), differentiable; the gates are saved only
    where autograd records and some input needs a gradient."""
    weights = [params[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    save = torch.is_grad_enabled() and any(a.requires_grad for a in (x, *weights))
    return LstmLayerFused.apply(x, save, span, *weights)
