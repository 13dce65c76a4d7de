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
import torch.nn.functional as F

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
    lib.aec_fsn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
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
           lib: ctypes.CDLL) -> torch.Tensor:
    """One launch of ``lib``'s K11 on checked inputs (the weights in
    ``_LEAVES`` order) -> ys (B, T, F, Hsb); raises where the plan needs
    more shared memory than a CTA has."""
    b, t, h4f = xp_fb.shape
    f, h4s = xp_sb.shape[2], xp_sb.shape[3]
    hf, hs = h4f // 4, h4s // 4
    w_fb, w_out, b_out, w_ih_sb, w_sb = (w.detach() for w in weights)
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
    err = lib.aec_fsn(
        _build.ptr(xp_fb), _build.ptr(xp_sb), _build.ptr(w_fb), _build.ptr(w_out),
        _build.ptr(b_out), _build.ptr(w_col), _build.ptr(w_sb), _build.ptr(emb),
        _build.ptr(ys), b, t, f, hf, hs, xp_fb.device.index, _build.stream_of(xp_fb),
    )
    _build.check(err, "fullsubnet")
    return ys


def joint_recurrence(params: dict, xp_fb: torch.Tensor, xp_sb: torch.Tensor) -> torch.Tensor:
    """The joint recurrence over the hoisted projections ``xp_fb`` (B, T,
    4Hfb) and ``xp_sb`` (B, T, F, 4Hsb) with the weights in ``params`` (the
    FullSubNet tree) -> the sub-band hidden sequence (B, T, F, Hsb), from
    zero state.

    A CUDA tensor launches K11 (or raises: not fp32, not contiguous, a zero
    size, a B whose rows a consumer CTA's shared memory cannot hold, a card
    that cannot place two clusters); a CPU tensor takes the plain loop.
    """
    if xp_fb.device.type == "cpu":
        from aec_tpu_torch.models.fullsubnet import _joint_scan_hs

        return _joint_scan_hs(params, xp_fb, xp_sb)
    weights = [params[a][b] for a, b in _LEAVES]
    _check(xp_fb, xp_sb, weights)
    ys = launch(weights, xp_fb, xp_sb, _lib())
    joint_recurrence.launches += 1
    return ys


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
