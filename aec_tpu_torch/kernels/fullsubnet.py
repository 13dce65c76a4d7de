"""Kernel K11: FullSubNet's joint full/sub-band LSTM recurrence in one CUDA launch, differentiable.

Replaces ``aec_tpu/kernels/pallas_fullsubnet.py:106`` (``_fsn_joint_fused_fwd``,
``pallas_call`` at ``:154``) and its custom VJP ``fsn_joint_fused``
(``:188-217``). The kernel is ``csrc/fullsubnet.cu``: one launch of
thread-block clusters of 8 CTAs, all co-resident. Cluster 0 is the producer:
it steps the full-band LSTM of every utterance over all frames, sending h
into every CTA's shared memory by ``st.async`` counted on mbarriers (no
cluster or grid barrier a frame), and publishes each frame's embedding as
words that carry their step. The other clusters are consumers: each CTA
steps its own (utterance, bin) rows of the sub-band LSTM, waiting only on
those rows' embedding words, its inputs staged ahead by TMA (the source's
header has the design and what bounds it; :func:`fsn_plan` mirrors its
launch plan, :func:`joint_recurrence_split` its order of work).
Everything stays fp32 (JAX's TPU kernel rounds the dots' operands to bf16).
JAX's kernel takes one utterance; this one takes B >= 1.

The hoisted input projections with every bias (in
``models.fullsubnet.fullsubnet_masks``) and the mask head stay outside, as
in JAX.
:class:`FsnJointFused` computes what the JAX custom VJP computes: the
forward through K11 (its plain version on the CPU), which, when a gradient
is wanted, also saves each band's activated gates and c and the embedding
before its ReLU; the backward runs K9b (``kernels/lstm_bwd.py``) over the
sub band, then, through the embedding, over the full band, and forms the
weight gradients as plain products over all frames (JAX's backward is
``jax.vjp`` of the scan, which XLA compiles into one loop on the device).
:func:`joint_recurrence` is the kernel's wrapper (a CUDA tensor launches K11
or raises, a CPU tensor takes the plain loop).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from aec_tpu_torch.kernels import _build
from aec_tpu_torch.ops.lstm import lstm_gates

_LEAVES = (("fb_lstm", "w_hh"), ("fb_out", "w"), ("fb_out", "b"), ("sb_lstm", "w_ih"),
           ("sb_lstm", "w_hh"))

# csrc/fullsubnet.cu's constants: CTAs a cluster, threads a CTA, weight
# positions a thread holds in registers, the producer's ring of xp_fb frames,
# the consumers' longest ring of xp_sb frames
CLUSTER, THREADS, REG_POS, PRODUCER_DEPTH, MAX_DEPTH = 8, 512, 4, 3, 8
# one weight position in shared memory: a float4 of 4 gates for every thread
POS_BYTES = 4 * 4 * THREADS * 4
PLAN_FIELDS = ("clusters", "consumers", "rows", "depth", "up", "sp", "np", "jrp", "jsp", "sc",
               "nc", "jrc", "jsc", "smem")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a build of ``csrc/fullsubnet.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_fsn.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.aec_fsn.restype = ctypes.c_int
    lib.aec_fsn_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.aec_fsn_plan.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("fullsubnet"))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _slices(units: int, quads: int) -> int:
    """Lanes a unit's k is split over: a power of two <= 32, no more than
    the quads of k, a unit for every group of lanes."""
    s = 32
    while s > 1 and (s > quads or s * units > THREADS):
        s //= 2
    return s


def pass_rows(n: int) -> int:
    """Rows of a pass over n rows (the producer's utterances, a consumer's
    rows): the smallest power of two >= n, at most 4."""
    return 1 if n <= 1 else 2 if n <= 2 else 4


def fsn_plan(b: int, f: int, hf: int, hs: int, *, clusters: int = 15,
             smem_cap: int = 232448) -> dict:
    """K11's launch plan for B utterances, F bins, widths Hf and Hs, on a card
    that places ``clusters`` clusters of 8 CTAs at once (one CTA an SM; the
    132-SM H100 of PERF.md places 15) and gives a CTA ``smem_cap`` bytes of
    shared memory
    (``csrc/fullsubnet.cu`` ``make_plan`` repeats it):

    - ``clusters``: the grid, one producer cluster and the consumers'; ``consumers``
      their CTAs, ``rows`` the (utterance, bin) rows a consumer CTA holds at
      most, ``depth`` its ring of xp_sb frames;
    - the producer: ``up`` units a CTA, ``sp`` lanes a unit, ``np`` weight
      positions a lane (a float4 of each of the 4 gate rows; a row of W_hh and
      of h is ``4 sp np`` floats, zero past the width), ``jrp`` of them in
      registers, ``jsp`` in shared memory, the rest (``l2_bytes`` a CTA a
      step) read from L2;
    - the consumers: ``sc``, ``nc``, ``jrc``, ``jsc`` the same (none from L2);
    - ``smem``: the bytes of shared memory the larger role needs.

    A plan whose ``smem`` exceeds ``smem_cap`` is one the card cannot take.
    """
    nf, up = _cdiv(f, CLUSTER), 4 * _cdiv(hf, 4 * CLUSTER)
    if hf % 4:
        raise ValueError(f"K11's full-band width is a multiple of 4 (launch pads it), got {hf}")
    if up > THREADS or hs > THREADS:
        raise ValueError(f"K11 steps at most {THREADS} units a CTA: full-band {hf} / "
                         f"{CLUSTER} CTAs, sub-band {hs}")
    sp = _slices(up, hf // 4)
    np_ = _cdiv(hf // 4, sp)
    jrp = min(np_, REG_POS)
    bp = _cdiv(b, pass_rows(b)) * pass_rows(b)
    # h_fb's three slots, the mbarriers of those and of the xp_fb ring (2
    # floats each, to 16 bytes), W_out's rows, the xp_fb ring, c, b_out
    other = 4 * (3 * bp * 4 * sp * np_ + 4 * _cdiv(3 + PRODUCER_DEPTH, 2) + nf * hf
                 + PRODUCER_DEPTH * b * 4 * up + b * up + nf)
    jsp = min(np_ - jrp, max(smem_cap - other, 0) // POS_BYTES)
    sc = _slices(hs, _cdiv(hs, 4))
    nc = _cdiv(_cdiv(hs, 4), sc)
    jrc = min(nc, REG_POS)
    jsc = nc - jrc
    cc = min(clusters - 1, _cdiv(b * f, CLUSTER))
    if cc < 1:
        raise ValueError("K11 needs a card that places two clusters of 8 CTAs at once")
    rows = _cdiv(b * f, cc * CLUSTER)

    def consumer_bytes(depth):
        rp = _cdiv(rows, pass_rows(rows)) * pass_rows(rows)
        # the ring and its mbarriers, h's two slots, c, emb's two slots
        return jsc * POS_BYTES + 4 * (depth * rows * 4 * hs + 4 * _cdiv(depth, 2)
                                      + 2 * rp * 4 * sc * nc + rows * hs + 2 * rows)

    depth = MAX_DEPTH
    while depth > 2 and consumer_bytes(depth) > smem_cap:
        depth -= 1
    plan = dict(clusters=cc + 1, consumers=cc * CLUSTER, rows=rows, depth=depth, up=up, sp=sp,
                np=np_, jrp=jrp, jsp=jsp, sc=sc, nc=nc, jrc=jrc, jsc=jsc,
                smem=max(other + jsp * POS_BYTES, consumer_bytes(depth)))
    plan["l2_bytes"] = (np_ - jrp - jsp) * POS_BYTES
    return plan


def card_plan(b: int, f: int, hf: int, hs: int, device: torch.device,
              lib: ctypes.CDLL | None = None) -> dict:
    """The plan ``csrc/fullsubnet.cu`` makes for this shape on the card (the
    clusters it places there), with :data:`PLAN_FIELDS`."""
    lib = lib or _lib()
    index = torch.cuda.current_device() if device.index is None else device.index
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    _build.check(lib.aec_fsn_plan(b, f, hf, hs, index, out), "fullsubnet plan")
    return dict(zip(PLAN_FIELDS, out))


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


def _padded(w: torch.Tensor, n: int) -> torch.Tensor:
    """``w`` contiguous with its rows zero-padded to ``n`` floats (the kernel
    reads whole float4s of every lane's slices)."""
    return (F.pad(w, (0, n - w.shape[-1])) if n > w.shape[-1] else w).contiguous()


def launch(weights: list[torch.Tensor], xp_fb: torch.Tensor, xp_sb: torch.Tensor,
           lib: ctypes.CDLL, save: bool = False):
    """One launch of ``lib``'s K11 on checked inputs (the weights in
    ``_LEAVES`` order) -> ys (B, T, F, Hsb), with ``save`` (ys, the full
    band's gates and c (B, T, 5Hfb), the embedding before its ReLU (B, T, F),
    the sub band's gates and c (B, T, F, 5Hsb)); raises where the plan needs
    more shared memory than a CTA has."""
    b, t, h4f = xp_fb.shape
    f, h4s = xp_sb.shape[2], xp_sb.shape[3]
    hf, hs = h4f // 4, h4s // 4
    w_fb, w_out, b_out, w_ih_sb, w_sb = (w.detach() for w in weights)
    hf_in = hf
    if hf % 4:  # full-band units with zero inputs and weights stay zero: the same function
        pad = -hf % 4
        xp_fb = F.pad(xp_fb.reshape(b, t, 4, hf), (0, pad)).reshape(b, t, 4 * (hf + pad))
        w_fb = F.pad(w_fb.reshape(4, hf, hf), (0, pad, 0, pad)).reshape(4 * (hf + pad), hf + pad)
        w_out, hf = F.pad(w_out, (0, pad)), hf + pad
    plan = card_plan(b, f, hf, hs, xp_fb.device, lib)
    _build.check_smem(plan["smem"], xp_fb.device,
                      "the FullSubNet joint kernel (the sub-band rows of a consumer CTA, their "
                      "xp_sb ring and W_hh; the producer's h_fb, W_out rows and W_hh)")
    # held until the launch is enqueued
    w_fb = _padded(w_fb, 4 * plan["sp"] * plan["np"])
    w_sb = _padded(w_sb, 4 * plan["sc"] * plan["nc"])
    w_out, b_out, w_col = w_out.contiguous(), b_out.contiguous(), w_ih_sb[:, -1].contiguous()
    emb = torch.zeros((t, b * f), dtype=torch.int64, device=xp_fb.device)
    ys = xp_fb.new_empty((b, t, f, hs))
    saved = ((xp_fb.new_empty((b, t, 5 * hf)), xp_fb.new_empty((b, t, f)),
              xp_sb.new_empty((b, t, f, 5 * hs))) if save else (None, None, None))
    err = lib.aec_fsn(
        _build.ptr(xp_fb), _build.ptr(xp_sb), _build.ptr(w_fb), _build.ptr(w_out),
        _build.ptr(b_out), _build.ptr(w_col), _build.ptr(w_sb), _build.ptr(emb),
        _build.ptr(ys), *(None if a is None else _build.ptr(a) for a in saved),
        b, t, f, hf, hs, xp_fb.device.index, _build.stream_of(xp_fb),
    )
    _build.check(err, "fullsubnet")
    if not save:
        return ys
    save_fb = saved[0]
    if hf != hf_in:
        save_fb = save_fb.reshape(b, t, 5, hf)[..., :hf_in].reshape(b, t, 5 * hf_in)
    return ys, save_fb, saved[1], saved[2]


def joint_recurrence(params: dict, xp_fb: torch.Tensor, xp_sb: torch.Tensor,
                     save: bool = False):
    """The joint recurrence over the hoisted projections ``xp_fb`` (B, T,
    4Hfb) and ``xp_sb`` (B, T, F, 4Hsb) with the weights in ``params`` (the
    FullSubNet tree) -> the sub-band hidden sequence (B, T, F, Hsb), from
    zero state; with ``save`` also what the backward reads (the full band's
    activated gates and c, the embedding before its ReLU, the sub band's
    gates and c: ``models.fullsubnet._joint_scan_hs``'s contract), the
    sequence the same bits.

    A CUDA tensor launches K11 (or raises: not fp32, not contiguous, a zero
    size, a B whose rows a consumer CTA's shared memory cannot hold, a card
    that cannot place two clusters); a CPU tensor takes the plain loop.
    """
    if xp_fb.device.type == "cpu":
        from aec_tpu_torch.models.fullsubnet import _joint_scan_hs

        return _joint_scan_hs(params, xp_fb, xp_sb, save)
    weights = [params[a][b] for a, b in _LEAVES]
    _check(xp_fb, xp_sb, weights)
    out = launch(weights, xp_fb, xp_sb, _lib(), save)
    joint_recurrence.launches += 1
    return out


joint_recurrence.launches = 0


def joint_recurrence_split(params: dict, xp_fb: torch.Tensor, xp_sb: torch.Tensor) -> torch.Tensor:
    """K11's order of work in plain torch: the full-band LSTM and the
    embedding over all frames first (the producer), then the sub-band rows
    over all frames (the consumers), which read only their own state and
    the embedding. The same sums as ``models.fullsubnet._joint_scan_hs``
    frame by frame; a model for the CPU tests of the independence the
    kernel's design rests on."""
    b, t, four_hfb = xp_fb.shape
    f, four_hsb = xp_sb.shape[2], xp_sb.shape[3]
    w_hh_fb, w_hh_sb = params["fb_lstm"]["w_hh"].T, params["sb_lstm"]["w_hh"].T
    hf = cf = xp_fb.new_zeros((b, four_hfb // 4))
    h_fb = []
    for i in range(t):
        hf, cf = lstm_gates(xp_fb[:, i] + hf @ w_hh_fb, cf)
        h_fb.append(hf)
    h_fb = torch.stack(h_fb, dim=1) if h_fb else xp_fb.new_zeros((b, 0, four_hfb // 4))
    emb = torch.relu(h_fb @ params["fb_out"]["w"].T + params["fb_out"]["b"])  # [B, T, F]
    sb_x = xp_sb + emb[..., None] * params["sb_lstm"]["w_ih"][:, -1]
    hs = cs = xp_fb.new_zeros((b * f, four_hsb // 4))
    out = []
    for i in range(t):
        hs, cs = lstm_gates(sb_x[:, i].reshape(b * f, four_hsb) + hs @ w_hh_sb, cs)
        out.append(hs.reshape(b, f, four_hsb // 4))
    return torch.stack(out, dim=1) if out else xp_sb.new_zeros((b, 0, f, four_hsb // 4))


class FsnJointFused(torch.autograd.Function):
    """``(xp_fb, xp_sb, save, *the 5 weights) -> hs_seq``: forward through
    K11 (plain on the CPU), saving what the backward reads where ``save``
    (autograd records and some input wants a gradient: every forward that
    has a backward); backward through K9b over each band (plain on the CPU)
    and products over all frames. The full band never reads the sub band,
    so the sub band's backward comes first and hands the full band its
    cotangent: K9b over the B F sub-band rows gives dxp_sb; through the
    embedding column, the ReLU and W_out, dh_fb; K9b over the B full-band
    rows gives dxp_fb; the weight gradients are products over all frames."""

    @staticmethod
    def forward(ctx, xp_fb, xp_sb, save, *weights):
        out = joint_recurrence(_params(weights), xp_fb.contiguous(), xp_sb.contiguous(), save)
        if not save:
            return out
        ctx.save_for_backward(*out, *weights)
        return out[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        from aec_tpu_torch.kernels.lstm_bwd import lstm_backward

        hs_seq, save_fb, pre, save_sb, w_fb, w_out, b_out, w_ih_sb, w_sb = ctx.saved_tensors
        f, hs, hf = hs_seq.shape[2], hs_seq.shape[3], w_fb.shape[-1]
        w_col = w_ih_sb[:, -1]
        dxp_sb = lstm_backward(g.contiguous()[None], save_sb[None], w_sb)[0]  # (B, T, F, 4Hsb)
        d_pre = (dxp_sb @ w_col) * (pre > 0)  # (B, T, F)
        dh_fb = d_pre @ w_out  # (B, T, Hfb)
        dxp_fb = lstm_backward(dh_fb[None, :, :, None], save_fb[None, :, :, None], w_fb)[0, :, :, 0]
        h_fb = save_fb[..., 3 * hf: 4 * hf] * torch.tanh(save_fb[..., 4 * hf:])  # o tanh(c)
        rows_sb = dxp_sb.reshape(-1, 4 * hs)
        d_w_col = torch.relu(pre).reshape(1, -1) @ rows_sb
        d_w_ih = torch.zeros_like(w_ih_sb)
        d_w_ih[:, -1] = d_w_col[0]
        grads = (dxp_fb, dxp_sb, None,
                 dxp_fb.reshape(-1, 4 * hf).T @ _previous(h_fb).reshape(-1, hf),
                 d_pre.reshape(-1, f).T @ h_fb.reshape(-1, hf), d_pre.sum((0, 1)), d_w_ih,
                 rows_sb.T @ _previous(hs_seq).reshape(-1, hs))
        return tuple(d if n else None for d, n in zip(grads, ctx.needs_input_grad))


def _previous(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, T, ...) one frame later: frame t holds x[:, t - 1], frame 0
    zeros (each step's h_{t-1})."""
    return F.pad(x, (0,) * (2 * (x.ndim - 2)) + (1, 0))[:, :x.shape[1]]


def fsn_joint_fused(params: dict, xp_fb: torch.Tensor, xp_sb: torch.Tensor) -> torch.Tensor:
    """The fused joint recurrence, differentiable in both projections and the
    weights it reads: ([B, T, 4Hfb], [B, T, F, 4Hsb]) -> [B, T, F, Hsb]. K11
    saves what the backward reads only where autograd records and some input
    needs a gradient."""
    weights = [params[a][b] for a, b in _LEAVES]
    save = torch.is_grad_enabled() and any(a.requires_grad for a in (xp_fb, xp_sb, *weights))
    return FsnJointFused.apply(xp_fb, xp_sb, save, *weights)
