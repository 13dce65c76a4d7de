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
design and the reckoning): CTAs each owning a run of rows and a chunk of
units with their columns of W_hh on chip, each step's inputs streamed into
shared memory by TMA a block ahead. The plan, chosen by shape, says how a
step's gradients dxp(t) reach the next step's dots: "local" puts every unit
in one CTA and splits the rows (a narrow W_hh; dxp stays in the CTA's
shared memory), "cluster" spreads a group's units over one thread-block
cluster whose CTAs push their slices of dxp into each other's shared memory
by bulk copies (FullSubNet's full band), "split" gives each CTA the rows of
W_hh of its own units' gates, so its dots need only its own dxp and the
group sums partial carry_h through device memory (DCCRN), and "grid", where
the split plan does not fit (H > 1024), spreads the units over co-resident
CTAs that take dxp from device memory by TMA once each producer's flag has
published it.

Layout: G groups, each with its W_hh (4H, H), each over B x F rows (B
sequences of T steps, F rows a step): ``g_ys`` (G, B, T, F, H), ``saved``
(G, B, T, F, 5H) = each step's activated i, f, g, o and c, ``dxp`` (G, B, T,
F, 4H). DCCRN's grouped LSTM is (2, 2 batch, T, 1, .), FullSubNet's sub band
(1, batch, T, 161, .) as its tensors lie, its full band (1, batch, T, 1, .).
The weight gradients are products over all rows outside the kernel.

Host side. :func:`backward_plan` chooses the plan, each warp's columns and
k-slice, where its quads of W lie and the blocks of rows;
:func:`pack_backward` builds that layout, cached per weight tensor by
``kernels/lstm.py``'s
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a build of ``csrc/lstm_bwd.cu`` (the route's,
    or a cut variant of ``kernels/lstm_bwd_costs.py``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_lstm_bwd.argtypes = [p] * 6 + [i] * 19 + [p]
    lib.aec_lstm_bwd.restype = ctypes.c_int
    lib.aec_lstm_bwd_clusters.argtypes = [i] * 4
    lib.aec_lstm_bwd_clusters.restype = ctypes.c_int
    if lib.aec_lstm_bwd_reg_quads() != REG_QUADS:
        raise RuntimeError("csrc/lstm_bwd.cu holds another number of register quads than "
                           "kernels/lstm_bwd.py packs")
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("lstm_bwd"))


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


MODES = ("local", "cluster", "grid", "split")  # the exchange, csrc/lstm_bwd.cu's Mode
SPLIT_ROWS = 16  # the split plan's rows a pass of the dots (kSplitRows)
SPLIT_REGS = 48  # the split plan's registers of W a thread (kSplitRegs)
MAX_CLUSTER = 16  # the widest cluster plan, past the portable 8 (kMaxCluster)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """Where K9b keeps W_hh and how a step's dxp reaches the CTAs. CTA ((g
    runs + run) nchunk + chunk) owns rows [run ``run_rows``, + ``run_rows``)
    of group g and units [chunk U, chunk U + U), the CTA's columns c < U
    (column c: W_hh[:, chunk U + c], 4H long). Warp w sums columns (w % wc)
    cw + i (i < ``cw``) over k-slice w // wc of the 4H (``ks`` slices of 32
    ``npos`` quads; wc = 16 / ks); its lane l holds the quads 32 npos slice
    + l + 32 j (j < ``npos``) of its columns: in registers for j <
    ``jreg``, in shared memory for j < ``jreg + jsm``, else read from L2
    each sweep. A CTA takes its rows in blocks of ``block_rows``. ``mode``:
    "local" (every unit in the CTA, dxp(t) kept in its shared memory),
    "cluster" (the group one cluster of ``nchunk`` CTAs, dxp(t) pushed into
    every CTA's shared memory; k runs chunk-major there, :func:`k_order`),
    "grid" (dxp(t) through device memory under a flag a CTA, ``round_rows``
    rows at a time into a ring of ``nbuf`` buffers), "split" (the product split
    over k: CTA chunk holds the 4U rows of W_hh of its own units' gates,
    ``npos`` = 4U k-values, ``jreg`` of them in registers and ``jsm`` in
    shared memory, ``cw`` columns a thread (1 or 2, H <= 512 cw); it forms
    every unit's partial carry_h from its own dxp(t + 1) and the group sums
    the partials through device memory). ``hidden`` is H rounded up to a
    multiple of 4 (the wrapper pads)."""

    groups: int
    rows: int
    hidden: int
    mode: str
    runs: int
    run_rows: int
    block_rows: int
    units: int
    nchunk: int
    cw: int
    ks: int
    npos: int
    jreg: int
    jsm: int
    round_rows: int
    nbuf: int
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
    def cluster(self) -> int:
        """CTAs a thread-block cluster."""
        return self.nchunk if self.mode == "cluster" else 1

    @property
    def kquads(self) -> int:
        """Quads of k a row of dxp holds on chip (cluster: nchunk chunks of 4U floats)."""
        return self.nchunk * self.units if self.mode == "cluster" else self.hidden

    def describe(self) -> str:
        """The plan's fields past its shape, for a report line."""
        skip = ("groups", "rows", "hidden")
        return ", ".join(f"{k} {v}" for k, v in dataclasses.asdict(self).items() if k not in skip)

    @property
    def layout(self) -> tuple:
        """What the packed weights depend on."""
        return (self.mode == "split", self.hidden, self.units, self.nchunk, self.cw, self.ks,
                self.npos)


def plan_smem(mode: str, hidden: int, run_rows: int, block_rows: int, units: int, nchunk: int,
              cw: int, ks: int, jsm: int, round_rows: int, nbuf: int) -> int:
    """Bytes of shared memory a CTA of the plan takes (``bwd_smem`` in
    ``csrc/lstm_bwd.cu``): W's shared quads, dxp(t + 1)'s rows (local: the
    run's; cluster: two slots of every row, nchunk 4U floats each; grid:
    ``nbuf`` buffers of ``round_rows``), the k-slices' sums of a block,
    carry_c and the carried c, the inputs' two slots, six mbarriers."""
    if mode == "split":  # W's shared k-values, dxp's own k-range, carry_c and c, the inputs
        rows_p = -(-run_rows // SPLIT_ROWS) * SPLIT_ROWS
        return 4 * (jsm * cw * THREADS + 4 * units * rows_p + 2 * run_rows * units
                    + 2 * block_rows * 6 * units + 12)
    dg = {"local": run_rows * 4 * hidden, "cluster": 2 * run_rows * 4 * nchunk * units,
          "grid": nbuf * round_rows * 4 * hidden}[mode]
    return 4 * (jsm * cw * THREADS * 4 + dg
                + ks * block_rows * (WARPS // ks) * cw + 2 * run_rows * units
                + 2 * block_rows * 6 * units + 12)


def _warp_layout(units: int, hidden: int, cw: int | None = None) -> tuple[int, int, int] | None:
    """(cw, ks, npos) with the fewest padded FMA slots a row for U columns
    of length 4H = H quads, among equals cw = 4 first, then 8, 2, 16, 1:
    four columns a warp reduce over the lanes with a quarter of cw = 16's
    shuffles and sweep more rows per read of W, against fewer columns a
    staged quad serves (the full band's cluster ran fastest at cw 4 on
    the H100, ``lstm_bwd_costs --plans``); ``cw`` forces the columns a
    warp. None where 16 warps of cw columns cannot hold U."""
    best = None
    for cw in (4, 8, 2, 16, 1) if cw is None else (cw,):
        wc = 1 << (-(-units // cw) - 1).bit_length()
        if wc > WARPS:
            continue
        ks = WARPS // wc
        npos = -(-hidden // (LANES * ks))
        slots = wc * cw * ks * LANES * npos
        if best is None or slots < best[0]:
            best = (slots, cw, ks, npos)
    return None if best is None else best[1:]


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def backward_plan(groups: int, rows: int, hidden: int, sms: int, smem_optin: int,
                  reg_quads: int = REG_QUADS, cw: int | None = None,
                  max_cluster: int = MAX_CLUSTER) -> BackwardPlan:
    """K9b's plan for G = ``groups`` recurrences of R = ``rows`` rows at H
    = ``hidden`` (rounded up to a multiple of 4) on a card of ``sms`` SMs
    giving a CTA ``smem_optin`` bytes of shared memory and placing clusters
    of up to ``max_cluster`` CTAs, chosen by shape:

    - "local" where all of W_hh^T fits one CTA's registers and shared
      memory beside its rows: every unit in each CTA, the rows in runs over
      about one CTA an SM;
    - "cluster" where a group's W_hh fits a cluster of 2 to ``max_cluster``
      CTAs (the widest that fits) with two slots of every row of dxp in
      each CTA;
    - "split" where H <= 1024 and a CTA's rows of W (4U of them, H long)
      fit its registers (48 a thread, :data:`SPLIT_REGS`) and shared
      memory: U = H / (SMs / G) units a CTA, rounded up to a multiple of 4;
    - "grid" otherwise: one run of all R rows, the units in chunks of U (at
      most one CTA an SM, 16 to 64 units), W's positions in registers, then
      shared memory, the rest from L2, and rounds of 2 rows through 2
      buffers.

    Each takes as much of W into shared memory as fits, then the largest
    block of rows (the wrapper raises where nothing fits). ``cw`` forces
    the columns a warp (``kernels/lstm_bwd_costs.py``)."""
    return _plan(None, groups, rows, hidden, sms, smem_optin, reg_quads, cw, max_cluster)


def _plan(mode: str | None, groups: int, rows: int, hidden: int, sms: int, smem_optin: int,
          reg_quads: int = REG_QUADS, cw: int | None = None,
          max_cluster: int = MAX_CLUSTER) -> BackwardPlan:
    """:func:`backward_plan`, or with ``mode`` its plan of that exchange (the
    tests and ``kernels/lstm_bwd_costs.py`` take each at shapes where the
    choice by shape takes another; ValueError where it cannot hold the
    shape)."""
    hidden = _round4(hidden)

    def make(mode: str, units: int, nchunk: int, runs: int) -> BackwardPlan | None:
        run_rows = -(-rows // runs)
        runs = -(-rows // run_rows)
        layout = _warp_layout(units, nchunk * units if mode == "cluster" else hidden, cw)
        if layout is None:
            return None
        cw_, ks, npos = layout
        jreg = min(reg_quads // cw_, npos)
        blocks = [run_rows] if mode == "cluster" else sorted(
            {-(-run_rows // k) for k in range(1, run_rows + 1)}, reverse=True)
        for jsm in range(npos - jreg, -1, -1):
            if mode != "grid" and jreg + jsm < npos:
                return None  # local and cluster hold all of W on chip
            for nbuf, ring in ((2, 2), (1, 1)) if mode == "grid" else ((0, 0),):
                for rb in blocks:
                    rr_ = min(ring, rb)
                    smem = plan_smem(mode, hidden, run_rows, rb, units, nchunk, cw_, ks, jsm,
                                     rr_, nbuf)
                    if smem <= smem_optin:
                        return BackwardPlan(groups, rows, hidden, mode, runs, run_rows, rb, units,
                                            nchunk, cw_, ks, npos, jreg, jsm, rr_, nbuf, smem)
        return None

    if mode is not None and mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if hidden <= WARPS * 16 and mode in (None, "local"):  # the widest a CTA's columns go
        a = make("local", hidden, 1, max(1, min(rows, sms // groups)))
        if a is not None:
            return a
    for size in (16, 8, 4, 2) if mode in (None, "cluster") else ():
        units = _round4(-(-hidden // size))
        nchunk = -(-hidden // units)
        if (nchunk < 2 or nchunk > max_cluster or groups * nchunk > sms
                or rows * 16 * hidden >= 1 << 20):
            continue
        c = make("cluster", units, nchunk, 1)
        if c is not None:
            return c
    if mode in (None, "split") and cw in (None, 1, 2) and hidden <= 2 * THREADS:
        cpt = cw or (1 if hidden <= THREADS else 2)
        units = _round4(-(-hidden // max(1, sms // groups)))
        if mode == "split":  # at least two chunks
            units = min(units, _round4(-(-hidden // 2)))
        nchunk, k = -(-hidden // units), 4 * units
        jreg = min(k, SPLIT_REGS // cpt)
        smem = plan_smem("split", hidden, rows, rows, units, nchunk, cpt, 1, k - jreg, 0, 0)
        if smem <= smem_optin and nchunk >= 2:
            return BackwardPlan(groups, rows, hidden, "split", 1, rows, rows, units, nchunk, cpt,
                                1, k, jreg, k - jreg, 0, 0, smem)
    units = _round4(min(max(-(-hidden // max(1, sms // groups)), 16), 64, hidden))
    if mode == "grid":  # at least two chunks
        units = min(units, _round4(-(-hidden // 2)))
    b = make("grid", units, -(-hidden // units), 1) if mode in (None, "grid") else None
    if b is None:
        raise ValueError(f"{units} columns a CTA do not fit 16 warps of {cw} columns, or no "
                         f"block of rows fits {smem_optin} B of shared memory")
    return b


def k_order(x: torch.Tensor, plan: BackwardPlan) -> torch.Tensor:
    """The last axis, 4H gate-major (i, f, g, o; H a multiple of 4), in the
    order K9b's dots take k: as it is, or for a cluster plan chunk-major
    (chunk, gate, unit < U), a last chunk's units past H zero ->
    ``plan.kquads`` quads."""
    if plan.mode != "cluster":
        return x
    h, u, nchunk = plan.hidden, plan.units, plan.nchunk
    x = F.pad(x.reshape(*x.shape[:-1], 4, h), (0, nchunk * u - h))
    x = x.reshape(*x.shape[:-2], 4, nchunk, u).transpose(-3, -2)
    return x.reshape(*x.shape[:-3], 4 * nchunk * u)


def _k_order_inverse(x: torch.Tensor, plan: BackwardPlan) -> torch.Tensor:
    """The inverse of :func:`k_order` on its ``4 plan.kquads`` floats."""
    if plan.mode != "cluster":
        return x
    h, u, nchunk = plan.hidden, plan.units, plan.nchunk
    x = x.reshape(*x.shape[:-1], nchunk, 4, u).transpose(-3, -2)
    return x.reshape(*x.shape[:-3], 4, nchunk * u)[..., :h].reshape(*x.shape[:-3], 4 * h)


def _pad_hidden(w: torch.Tensor, hidden: int, fields: int) -> torch.Tensor:
    """The last dimension's ``fields`` blocks of H zero-padded to ``hidden`` each."""
    h = w.shape[-1] // fields
    if h == hidden:
        return w
    w = w.reshape(*w.shape[:-1], fields, h)
    return F.pad(w, (0, hidden - h)).reshape(*w.shape[:-2], fields * hidden)


def pack_backward(w_hh: torch.Tensor, plan: BackwardPlan) -> torch.Tensor:
    """``W_hh`` (G, 4H, H) -> (G nchunk, npos cw, 512, 4), as
    :class:`BackwardPlan` places it: quad j cw + i of thread w 32 + l of
    block g nchunk + chunk is ``W_hh[g][4 k + e, chunk U + c]``, e < 4, for
    column c = (w % wc) cw + i and quad k = 32 npos (w // wc) + l + 32 j
    of the rows in :func:`k_order`; zero past H and for the columns past U
    (an H that is no multiple of 4 padded first with zero units in every
    gate). One op chain per weight tensor, never per call."""
    g, u, h, nchunk, npos = plan.groups, plan.units, plan.hidden, plan.nchunk, plan.npos
    kq = plan.ks * LANES * npos
    if w_hh.shape[-1] != h:  # H padded to a multiple of 4: zero units in every gate
        w_hh = _pad_hidden(F.pad(w_hh, (0, h - w_hh.shape[-1])).transpose(1, 2), h, 4)
        w_hh = w_hh.transpose(1, 2)
    if plan.mode == "split":
        # [g, chunk, k = gate U + j, ci, thread] = W_hh[gate H + chunk U + j, thread + 512 ci]
        w = F.pad(w_hh.reshape(g, 4, h, h), (0, plan.cw * THREADS - h, 0, nchunk * u - h))
        w = w.reshape(g, 4, nchunk, u, plan.cw, THREADS).permute(0, 2, 1, 3, 4, 5)
        return w.reshape(g * nchunk, 4 * u, plan.cw, THREADS).contiguous()
    w = k_order(w_hh.transpose(1, 2), plan)  # (G, H, the rows of W_hh in the dots' order)
    w = F.pad(w, (0, 4 * kq - 4 * plan.kquads, 0, nchunk * u - h)).reshape(g, nchunk, u, 4 * kq)
    w = F.pad(w, (0, 0, 0, plan.cols - u))
    w = w.reshape(g, nchunk, plan.wc, plan.cw, plan.ks, npos, LANES, 4)
    w = w.permute(0, 1, 5, 3, 4, 2, 6, 7)  # [g, chunk, j, i, slice, wc, l, e]
    return w.reshape(g * nchunk, npos * plan.cw, THREADS, 4).contiguous()


def unpack_backward(packed: torch.Tensor, plan: BackwardPlan) -> torch.Tensor:
    """The inverse of :func:`pack_backward`: -> ``W_hh`` (G, 4H, H)."""
    g, u, h, nchunk, npos = plan.groups, plan.units, plan.hidden, plan.nchunk, plan.npos
    if plan.mode == "split":
        w = packed.reshape(g, nchunk, 4, u, plan.cw * THREADS).permute(0, 2, 1, 3, 4)
        return w.reshape(g, 4, nchunk * u, -1)[:, :, :h, :h].reshape(g, 4 * h, h)
    w = packed.reshape(g, nchunk, npos, plan.cw, plan.ks, plan.wc, LANES, 4)
    w = w.permute(0, 1, 5, 3, 4, 2, 6, 7).reshape(g, nchunk, plan.cols, -1)[:, :, :u]
    w = w.reshape(g, nchunk * u, -1)[:, :h, :4 * plan.kquads]
    return _k_order_inverse(w, plan).transpose(1, 2)


def backward_modeled(g_ys: torch.Tensor, saved: torch.Tensor, packed: torch.Tensor,
                     plan: BackwardPlan) -> torch.Tensor:
    """K9b from the layout, in the kernel's summation order: each lane's dot
    over its quads in k order (:func:`k_order`; registers, shared memory,
    L2; fp32 products and sums here, FMAs in the kernel), the warp's 32
    lanes summed as a tree whose first level pairs lanes l and l + 16, the
    k-slices' sums added in slice order, then the cell. A model for the CPU
    tests: g_ys (G, R, T, H), saved (G, R, T, 5H) -> dxp (G, R, T, 4H)."""
    if plan.mode == "split":
        return _split_modeled(g_ys, saved, packed, plan)
    g, r, _, h = g_ys.shape
    u, nchunk, npos, ks, wc, cw = plan.units, plan.nchunk, plan.npos, plan.ks, plan.wc, plan.cw
    kq = ks * LANES * npos
    w = packed.reshape(g, nchunk, npos, cw, ks, wc, LANES, 4).permute(0, 1, 4, 5, 3, 6, 2, 7)
    w = w.reshape(g, nchunk, 1, ks, wc, cw, LANES, npos * 4)  # [g, chunk, -, q, cg, i, l, k]

    def carry_h(d):
        dv = k_order(_pad_hidden(d, plan.hidden, 4), plan)
        dv = F.pad(dv, (0, 4 * kq - dv.shape[-1])).reshape(g, r, ks, npos, LANES, 4)
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
        return ch.permute(0, 2, 1, 3).reshape(g, r, nchunk * u)[..., :h]

    return _cell_steps(g_ys, saved, carry_h)


def _cell_steps(g_ys: torch.Tensor, saved: torch.Tensor, carry_h) -> torch.Tensor:
    """The reverse loop's cells, ``carry_h(d)`` giving a step's carried
    gradient of h from the last step's dxp (None at the first): -> dxp (G,
    R, T, 4H)."""
    g, r, t, h = g_ys.shape
    carry_c = g_ys.new_zeros((g, r, h))
    d = None
    out = []
    for step in range(t - 1, -1, -1):
        ch = g_ys.new_zeros((g, r, h)) if d is None else carry_h(d)
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


def _split_modeled(g_ys: torch.Tensor, saved: torch.Tensor, packed: torch.Tensor,
                   plan: BackwardPlan) -> torch.Tensor:
    """The split plan's order: chunk q's partial of each column over its
    own k-values in order (k = gate U + j), then each unit's partials added
    in chunk order."""
    g, r, t, h = g_ys.shape
    u, nchunk, hp = plan.units, plan.nchunk, plan.hidden
    w = packed.reshape(g, nchunk, 4 * u, plan.cw * THREADS)[..., :hp]  # [g, q, k, col]

    def carry_h(d):
        dq = F.pad(_pad_hidden(d, hp, 4).reshape(g, r, 4, hp), (0, nchunk * u - hp))
        dq = dq.reshape(g, r, 4, nchunk, u).permute(0, 3, 1, 2, 4).reshape(g, nchunk, r, 4 * u)
        part = g_ys.new_zeros((g, nchunk, r, hp))
        for k in range(4 * u):
            part = part + dq[..., k:k + 1] * w[:, :, None, k]
        ch = part[:, 0]
        for q in range(1, nchunk):
            ch = ch + part[:, q]
        return ch[..., :h]

    return _cell_steps(g_ys, saved, carry_h)


# ---------------------------------------------------------------- the wrapper


def card_plan(groups: int, rows: int, hidden: int, device: torch.device,
              cw: int | None = None) -> BackwardPlan:
    """:func:`backward_plan` for this card: a cluster plan as wide as the
    card places (``cudaOccupancyMaxActiveClusters`` at the plan's shared
    memory; a cluster of 16 is a non-portable size), narrower otherwise."""
    index = torch.device(device).index
    return _card_plan(groups, rows, hidden, torch.cuda.current_device() if index is None
                      else index, cw)


@functools.cache
def _card_plan(groups: int, rows: int, hidden: int, index: int, cw: int | None) -> BackwardPlan:
    props = torch.cuda.get_device_properties(index)
    widest = MAX_CLUSTER
    while True:
        plan = backward_plan(groups, rows, hidden, props.multi_processor_count,
                             props.shared_memory_per_block_optin, cw=cw, max_cluster=widest)
        if plan.mode != "cluster" or _lib().aec_lstm_bwd_clusters(plan.nchunk, plan.smem, plan.cw,
                                                                  index) > 0:
            return plan
        widest = plan.nchunk - 1


def lstm_backward(g_ys: torch.Tensor, saved: torch.Tensor,
                  w_hh: torch.Tensor | Sequence[torch.Tensor]) -> torch.Tensor:
    """The recurrence's VJP (:func:`lstm_backward_plain`'s contract):
    ``g_ys`` (G, B, T, F, H), ``saved`` (G, B, T, F, 5H) from K9 or K11 with
    ``save``, ``w_hh`` (G, 4H, H) or the G groups' (4H, H) tensors -> dxp
    (G, B, T, F, 4H).

    A CUDA tensor launches K9b (or raises: not fp32, not contiguous, T = 0,
    a plan no CTA's shared memory holds, a grid the card cannot hold
    co-resident), with W_hh packed at its first call and cached; an H that
    is no multiple of 4 goes in padded with zero units; a CPU tensor takes
    the plain loop.
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
    plan = card_plan(g, b * f, h, g_ys.device)
    if plan.hidden != h:
        g_ys, saved = _pad_hidden(g_ys, plan.hidden, 1), _pad_hidden(saved, plan.hidden, 5)
    dxp = launch(plan, g_ys, saved, ws)
    lstm_backward.launches += 1
    if plan.hidden != h:
        dxp = dxp.reshape(g, b, t, f, 4, plan.hidden)[..., :h].reshape(g, b, t, f, 4 * h)
    return dxp


lstm_backward.launches = 0


def launch(plan: BackwardPlan, g_ys: torch.Tensor, saved: torch.Tensor,
           ws: list[torch.Tensor], lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """One launch of K9b at ``plan`` on checked inputs (H a multiple of 4,
    the plan's) -> dxp; raises where the plan needs more shared memory than
    a CTA has, or the card refuses the launch. ``lib``: another build of
    the source (the cost tool's cut variants)."""
    g, b, t, f, h = g_ys.shape
    if h != plan.hidden or h % 4:
        raise ValueError(f"K9b's inputs must be padded to the plan's H = {plan.hidden}, got {h}")
    _build.check_smem(plan.smem, g_ys.device, f"the LSTM backward kernel ({plan.mode} plan: "
                      "W's shared quads, dxp's rows, a block's k-slice sums, its inputs)")
    packed = packed_weights(ws, plan, pack_backward)
    flags = torch.zeros(g * plan.nchunk, dtype=torch.int32, device=g_ys.device)
    dxp = g_ys.new_empty((g, b, t, f, 4 * h))
    part = (g_ys.new_empty(g * 2 * plan.nchunk ** 2 * b * f * plan.units)
            if plan.mode == "split" else None)
    err = (lib or _lib()).aec_lstm_bwd(
        _build.ptr(g_ys), _build.ptr(saved), _build.ptr(packed), _build.ptr(flags),
        _build.ptr(dxp), None if part is None else _build.ptr(part), g, b, t, f, h,
        MODES.index(plan.mode), plan.runs, plan.run_rows, plan.block_rows, plan.units,
        plan.nchunk, plan.cw, plan.ks, plan.npos, plan.jreg, plan.jsm, plan.round_rows, plan.nbuf,
        g_ys.device.index, _build.stream_of(g_ys))
    _build.check(err, "lstm_bwd")
    return dxp
