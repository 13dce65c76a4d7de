"""Kernels K8 and K8b: the GRU recurrence and its backward, one CUDA launch
each, differentiable.

K8 replaces ``aec_tpu/kernels/pallas_gru.py:65`` (``_gru_scan_fused_fwd``,
``pallas_call`` at ``:107``), K8b the backward of its custom VJP
``gru_scan_fused`` (``_bwd``, ``:159-166``). Both take any B and any H, as
the JAX kernel and its VJP do, on two plans:

- H <= 128, ``csrc/gru.cu``: one CTA per batch row walks the T steps with
  W_hh in registers (each hidden unit's three gate rows, for K8b its three
  gate columns, split over a team of lanes as :func:`pack_gru_lanes` lays
  them out) and a double-buffered vector in shared memory; a serial
  recursion, so one step's latency bounds it (the source's header has the
  reckoning). :func:`gru_recurrence_split` and :func:`gru_backward_split`
  model its summation order.
- H > 128, the wide path, ``csrc/gru_wide.cu``: one persistent grid of
  co-resident CTAs, each owning a few hidden units and holding their
  columns of W_hh on chip across the time loop (forward: the three gate
  rows of each unit; backward: each unit's column of W_hh), h (forward) or
  the gates' gradients (backward) exchanged through device memory in words
  that carry their step (a counter past 8 rows), no grid barrier.
  :func:`wide_plan` lays the columns out, :func:`pack_wide` packs them,
  :func:`gru_recurrence_wide_split` and :func:`gru_backward_wide_split`
  model its summation order. The plan is a pure function of (B, H);
  :func:`wide_fits` says whether it holds both directions on an H100.

:func:`packed_lanes` and :func:`packed_wide` cache the packings keyed on
W_hh's ``data_ptr()`` and ``_version`` (an entry holds the tensor, so no
other tensor can take its address while it lives): an optimizer step or a
``copy_`` makes the next call pack again, an in-place change through
``.data`` bypasses the version counter (call :func:`clear_cache` after one).

:class:`GruScanFused` computes what the JAX custom VJP computes: its
forward is the hoisted input projection as one ``torch.addmm`` (``b_hr`` and
``b_hz`` folded into its bias, ``b_hn`` left inside the reset product)
followed by the recurrence on K8, which, when a gradient is wanted, also
saves each step's r, z, n and ``h W_hn^T + b_hn``; its backward runs K8b
on them and forms the weight gradients as plain products over the B T
rows. JAX's backward is ``jax.vjp`` of the scan, which XLA compiles into
one loop on the device; eager PyTorch runs a loop as ~10 launches a step,
so the port's counterpart of that compiled loop is a kernel, at every
width. :func:`gru_recurrence` and :func:`gru_backward` are the kernels'
wrappers (a CUDA tensor launches the kernel or raises, a CPU tensor takes
:func:`gru_recurrence_plain` / :func:`gru_backward_plain`);
:func:`gru_scan_fused_plain` is the plain version of the whole forward.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from collections import OrderedDict

import torch
import torch.nn.functional as F

from aec_tpu_torch.kernels import _build


# K8's and K8b's register path (``kMaxHidden`` in ``csrc/gru.cu``); wider
# nets run the wide path (``csrc/gru_wide.cu``)
MAX_HIDDEN = 128
CACHE_SIZE = 8  # packed W_hh kept: a net's K8 and K8b layouts, a few nets
_PACKED: OrderedDict = OrderedDict()

# the wide path's plan (``csrc/gru_wide.cu`` repeats the constants it needs)
WIDE_CTAS = 128  # at most this many CTAs: one an SM on an H100 (132 SMs)
WIDE_THREADS, WIDE_WARPS, LANES = 512, 16, 32
WIDE_REG_QUADS = 8  # float4 quads of W a thread holds in registers (kRegQuads)
WIDE_TAG_ROWS = 8  # up to this many rows, words with their step (kTagRows)
SMEM_OPTIN = 232448  # bytes of shared memory an H100 gives one CTA


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_gru.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.aec_gru.restype = ctypes.c_int
    lib.aec_gru_backward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.aec_gru_backward.restype = ctypes.c_int
    return lib


@functools.cache
def _wide_lib() -> ctypes.CDLL:
    return bind_wide(_build.load("gru_wide"))


def bind_wide(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' types on a build of ``csrc/gru_wide.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_gru_wide_forward.argtypes = [p] * 8 + [i] * 13 + [p]
    lib.aec_gru_wide_forward.restype = ctypes.c_int
    lib.aec_gru_wide_backward.argtypes = [p] * 10 + [i] * 13 + [p]
    lib.aec_gru_wide_backward.restype = ctypes.c_int
    if (lib.aec_gru_wide_reg_quads(), lib.aec_gru_wide_tag_rows()) != (WIDE_REG_QUADS,
                                                                         WIDE_TAG_ROWS):
        raise RuntimeError("csrc/gru_wide.cu holds another plan than kernels/gru.py packs for")
    return lib


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """Where the wide path keeps W_hh (``csrc/gru_wide.cu``). CTA c owns
    units [c U, c U + U) and ``columns`` columns of length ``kdim`` (forward:
    column g U + j is row g H + c U + j of W_hh, against h; backward: column
    j is column c U + j of W_hh, against [dr^, dz^, d_hn]). Warp w = ks ncg +
    cg sums columns cg cw + i (i < cw) over slice ks of the vector, its lane
    l holding quads l + 32 (ks pps + j), j < pps: in registers for j <
    ``jreg``, else in shared memory. The vector lies padded to ``kp`` floats
    (whole positions of 128); ``tagged``: the exchange in words with their
    step, else floats and a counter."""

    backward: bool
    rows: int
    hidden: int
    units: int
    nchunk: int
    kdim: int
    kp: int
    cw: int
    ncg: int
    ks: int
    pps: int
    jreg: int
    tagged: bool
    smem: int  # bytes of shared memory a CTA

    @property
    def columns(self) -> int:
        return self.units if self.backward else 3 * self.units

    @property
    def layout(self) -> tuple:
        """What the packed weights depend on."""
        return (self.backward, self.units, self.kp, self.cw, self.ncg, self.ks)

    @property
    def holds(self) -> bool:
        """Whether an H100 holds the plan: the warps cover the columns and a
        CTA's shared memory its part (the kernel refuses otherwise)."""
        return self.ncg * self.ks <= WIDE_WARPS and self.smem <= SMEM_OPTIN


def wide_smem(rows: int, units: int, kp: int, cw: int, ncg: int, ks: int, pps: int,
              jreg: int) -> int:
    """Shared memory of one CTA, bytes (``csrc/gru_wide.cu`` wide_smem): W's
    shared quads, the rows' vectors, the slices' sums, two floats a cell."""
    return 4 * ((pps - jreg) * cw * WIDE_THREADS * 4 + rows * kp + ks * rows * ncg * cw
                + 2 * rows * units)


def wide_plan(rows: int, hidden: int, backward: bool) -> WidePlan:
    """The wide path's layout at B = ``rows``, H = ``hidden``, a pure
    function of the shape: U = ceil(H / 128) units a CTA (at most 128 CTAs,
    one an SM), the columns over the 16 warps in groups of ``cw`` = 4 (2
    where a CTA has two), the vector's positions over as many slices as the
    remaining warps allow and divide them evenly."""
    units = -(-hidden // WIDE_CTAS)
    nchunk = -(-hidden // units)
    columns = units if backward else 3 * units
    kdim = 3 * hidden if backward else hidden
    cw = 2 if columns <= 2 else 4
    ncg = -(-columns // cw)
    npos = -(-kdim // (4 * LANES))
    ks = max(d for d in range(1, max(1, min(WIDE_WARPS // ncg, npos)) + 1) if npos % d == 0)
    pps = npos // ks
    jreg = min(pps, WIDE_REG_QUADS // cw)
    kp = 4 * LANES * npos
    return WidePlan(backward, rows, hidden, units, nchunk, kdim, kp, cw, ncg, ks, pps, jreg,
                    rows <= WIDE_TAG_ROWS, wide_smem(rows, units, kp, cw, ncg, ks, pps, jreg))


def wide_fits(rows: int, hidden: int) -> bool:
    """Whether the wide path holds both K8 and K8b at B = ``rows``, H =
    ``hidden`` > 128 on an H100 (a pure function of the shape: the route
    takes it only where the backward can follow)."""
    return hidden > MAX_HIDDEN and all(wide_plan(rows, hidden, bwd).holds
                                       for bwd in (False, True))


def wide_columns(w_hh: torch.Tensor, plan: WidePlan) -> torch.Tensor:
    """``W_hh`` (3H, H) -> the CTAs' columns (nchunk, ncg cw, kp), zero past
    H, past the units and past the columns (:class:`WidePlan`)."""
    h, u, nchunk, kp = plan.hidden, plan.units, plan.nchunk, plan.kp
    w = w_hh.reshape(3, h, h)
    if plan.backward:  # column j of CTA c: W_hh[:, c U + j], the gates' rows in order
        cols = F.pad(w.permute(2, 0, 1).reshape(h, 3 * h), (0, kp - 3 * h, 0, nchunk * u - h))
        cols = cols.reshape(nchunk, u, kp)
    else:  # column g U + j of CTA c: W_hh[g H + c U + j, :]
        cols = F.pad(w, (0, kp - h, 0, nchunk * u - h)).reshape(3, nchunk, u, kp)
        cols = cols.transpose(0, 1).reshape(nchunk, 3 * u, kp)
    return F.pad(cols, (0, 0, 0, plan.ncg * plan.cw - plan.columns))


def pack_wide(w_hh: torch.Tensor, plan: WidePlan) -> torch.Tensor:
    """``W_hh`` (3H, H) -> (nchunk, pps cw, 512, 4), the quads of every
    thread as :class:`WidePlan` places them: quad j cw + i of thread (ks ncg
    + cg) 32 + l of CTA c is quad l + 32 (ks pps + j) of column cg cw + i of
    :func:`wide_columns`; the idle warps' quads zero. One op chain per
    weight tensor (:func:`packed_wide`), never per call."""
    cols = wide_columns(w_hh, plan).reshape(plan.nchunk, plan.ncg, plan.cw, plan.ks, plan.pps,
                                            LANES, 4)  # [c, cg, i, ks, j, l, e]
    w = cols.permute(0, 4, 2, 3, 1, 5, 6).reshape(plan.nchunk, plan.pps * plan.cw,
                                                  plan.ks * plan.ncg * LANES, 4)
    return F.pad(w, (0, 0, 0, WIDE_THREADS - plan.ks * plan.ncg * LANES)).contiguous()


def unpack_wide(packed: torch.Tensor, plan: WidePlan) -> torch.Tensor:
    """The inverse of :func:`pack_wide`: -> :func:`wide_columns`' (nchunk,
    ncg cw, kp)."""
    w = packed[:, :, : plan.ks * plan.ncg * LANES]
    w = w.reshape(plan.nchunk, plan.pps, plan.cw, plan.ks, plan.ncg, LANES, 4)
    return w.permute(0, 4, 2, 3, 1, 5, 6).reshape(plan.nchunk, plan.ncg * plan.cw, plan.kp)


def lane_plan(hidden: int) -> tuple[int, int, int]:
    """K8's layout at H = ``hidden`` <= 128 (``csrc/gru.cu`` repeats it):
    (P lanes per unit, C weights per lane and gate, unit slots). H <= 32
    runs one warp, a lane per unit (P = 1, 32 slots); wider nets a team of 4
    lanes per unit and the slots rounded up to whole warps."""
    p = 1 if hidden <= 32 else 4
    c = max(4, 1 << (-(-hidden // p) - 1).bit_length())
    units = 32 if p == 1 else -(-hidden // 8) * 8
    return p, c, units


def pack_gru_lanes(w_hh: torch.Tensor) -> torch.Tensor:
    """``W_hh`` (3H, H) -> (3 C/4, threads, 4), the registers of K8's
    lanes: chunk i of gate g for thread j P + l is ``W_hh[g H + j, 4 (l + P
    i) + e]``, e < 4, zero past H (:func:`lane_plan`); K8b's are this
    packing of the per-gate transpose. One op chain per weight tensor
    (:func:`packed_lanes`), never per step."""
    hidden = w_hh.shape[-1]
    p, c, units = lane_plan(hidden)
    w = w_hh.reshape(3, hidden, hidden)
    if (p * c, units) != (hidden, hidden):
        w = F.pad(w, (0, p * c - hidden, 0, units - hidden))
    w = w.reshape(3, units, c // 4, p, 4).permute(0, 2, 1, 3, 4)  # [g, i, j, l, e]
    return w.reshape(3 * c // 4, units * p, 4).contiguous()


def clear_cache() -> None:
    """Forget every packed W_hh."""
    _PACKED.clear()


def _cached(w_hh: torch.Tensor, layout: tuple, pack) -> torch.Tensor:
    """``pack(w_hh.detach())``, cached keyed on the tensor's ``data_ptr()``
    and ``_version`` and the ``layout`` (the entry holds the tensor)."""
    key = (w_hh.data_ptr(), w_hh._version, tuple(w_hh.shape), w_hh.dtype, w_hh.device, layout)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[0]
    _PACKED[key] = (pack(w_hh.detach()), w_hh)
    while len(_PACKED) > CACHE_SIZE:
        _PACKED.popitem(last=False)
    return _PACKED[key][0]


def packed_lanes(w_hh: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """:func:`pack_gru_lanes` of ``w_hh`` (K8's registers) or, with
    ``transposed``, of its per-gate transpose (K8b's), cached."""
    def pack(w):
        if transposed:
            hidden = w.shape[-1]
            w = w.reshape(3, hidden, hidden).transpose(1, 2).reshape(3 * hidden, hidden)
        return pack_gru_lanes(w)

    return _cached(w_hh, ("lanes", transposed), pack)


def packed_wide(w_hh: torch.Tensor, plan: WidePlan) -> torch.Tensor:
    """:func:`pack_wide` of ``w_hh`` for ``plan``, cached."""
    return _cached(w_hh, ("wide", *plan.layout), lambda w: pack_wide(w, plan))


def unpack_gru_lanes(packed: torch.Tensor, hidden: int) -> torch.Tensor:
    """The inverse of :func:`pack_gru_lanes`: -> ``W_hh`` (3H, H)."""
    p, c, units = lane_plan(hidden)
    w = packed.reshape(3, c // 4, units, p, 4).permute(0, 2, 1, 3, 4)  # [g, j, i, l, e]
    w = w.reshape(3, units, p * c)[:, :hidden, :hidden]
    return w.reshape(3 * hidden, hidden)


def gru_recurrence_split(xp: torch.Tensor, packed: torch.Tensor, b_hn: torch.Tensor,
                         h0: torch.Tensor) -> torch.Tensor:
    """K8's arithmetic in the kernel's summation order, from its packed
    weights: each lane's partial dot over its float4 chunks of h (chunk l +
    P i) into two accumulators by the parity of i, the accumulators added, a
    team of four summed as the kernel's reduce-scatter does, (s0 + s2) +
    (s1 + s3), then the gates. A model for the CPU tests (fp32, no fused
    multiply-add)."""
    b, hidden = h0.shape
    p, c, units = lane_plan(hidden)
    c4 = c // 4
    w = packed.reshape(3, c4, units, p, 4)
    h = F.pad(h0, (0, p * c - hidden))
    hs = []
    for t in range(xp.shape[1]):
        hv = h.reshape(b, c4, p, 4)  # float4 chunk i P + l of h at [:, i, l]
        acc = [h.new_zeros((b, 3, units, p)) for _ in range(2)]
        for i in range(c4):
            prod = w[:, i][None] * hv[:, i][:, None, None]  # (b, 3, units, p, 4)
            acc[i % 2] = (((acc[i % 2] + prod[..., 0]) + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
        s = acc[0] + acc[1]
        if p == 4:
            s = (s[..., 0] + s[..., 2]) + (s[..., 1] + s[..., 3])
        else:
            s = s[..., 0]
        s = s[:, :, :hidden]  # (b, 3, H)
        xr, xz, xn = torch.split(xp[:, t], hidden, dim=-1)
        r = torch.sigmoid(xr + s[:, 0])
        z = torch.sigmoid(xz + s[:, 1])
        n = torch.tanh(xn + r * (s[:, 2] + b_hn))
        hn = (1.0 - z) * n + z * h[:, :hidden]
        hs.append(hn)
        h = F.pad(hn, (0, p * c - hidden))
    return torch.stack(hs, dim=1)


def gru_backward_split(g_ys: torch.Tensor, gates: torch.Tensor, ys: torch.Tensor,
                       h0: torch.Tensor, packed_t: torch.Tensor):
    """K8b's arithmetic in the kernel's summation order, from its packed
    weights ``packed_t`` (:func:`pack_gru_lanes` of W_hh's per-gate
    transpose, wherever a lane keeps a chunk: registers or, at H = 128, the
    shared tail of gate n's column): each lane's partial of sum_g W_g^T d_g
    over its float4 chunks l + P i into two accumulators a gate by the
    parity of i, the gates' pairs added ((r + z) + n), a team of four summed
    as the kernel's xor shuffles do, (s0 + s1) + (s2 + s3), then z dh added.
    A model for the CPU tests (fp32, no fused multiply-add): the same
    contract as :func:`gru_backward_plain`."""
    b, t_steps, hidden = g_ys.shape
    p, c, units = lane_plan(hidden)
    c4 = c // 4
    w = packed_t.reshape(3, c4, units, p, 4)  # [g, i, j, l, e]
    carry = h0.new_zeros((b, hidden))
    dxps, dhns = [], []
    for t in range(t_steps - 1, -1, -1):
        dh = carry + g_ys[:, t]
        r, z, n, hn = torch.split(gates[:, t], hidden, dim=-1)
        hp = ys[:, t - 1] if t > 0 else h0
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dz = dh * (hp - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        dhn = dn * r
        d = F.pad(torch.stack([dr, dz, dhn], dim=1), (0, p * c - hidden))
        d = d.reshape(b, 3, c4, p, 4)  # float4 chunk i P + l of gate g at [:, g, i, l]
        acc = [h0.new_zeros((b, 3, units, p)) for _ in range(2)]
        for i in range(c4):
            prod = w[:, i][None] * d[:, :, i][:, :, None]  # (b, 3, units, p, 4)
            a = acc[i % 2]
            acc[i % 2] = (((a + prod[..., 0]) + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
        s = acc[0] + acc[1]
        s = (s[:, 0] + s[:, 1]) + s[:, 2]  # (b, units, p)
        s = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3]) if p == 4 else s[..., 0]
        carry = s[:, :hidden] + z * dh
        dxps.append(torch.cat([dr, dz, dn], dim=-1))
        dhns.append(dhn)
    return torch.stack(dxps[::-1], dim=1), torch.stack(dhns[::-1], dim=1), carry


def wide_dots(vec: torch.Tensor, packed: torch.Tensor, plan: WidePlan) -> torch.Tensor:
    """The wide path's dots in the kernel's summation order: ``vec`` (B,
    kdim) against every CTA's columns from the packed weights -> (B, nchunk,
    ncg cw). Each lane's sum over its quads l + 32 (ks pps + j) in k order
    (fp32 products and sums here, FMAs in the kernel), the warp's 32 lanes
    summed as a tree whose first level pairs lanes l and l + 16, then the KS
    slices added in order."""
    cols = unpack_wide(packed, plan).reshape(plan.nchunk, plan.ncg * plan.cw, plan.ks, plan.pps,
                                             LANES, 4)
    v = F.pad(vec, (0, plan.kp - vec.shape[-1])).reshape(-1, 1, 1, plan.ks, plan.pps, LANES, 4)
    acc = vec.new_zeros((vec.shape[0], plan.nchunk, plan.ncg * plan.cw, plan.ks, LANES))
    for j in range(plan.pps):
        for e in range(4):
            acc = acc + v[..., j, :, e] * cols[None, ..., j, :, e]
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:]
    s = acc[..., 0, 0]
    for m in range(1, plan.ks):
        s = s + acc[..., m, 0]
    return s


def gru_recurrence_wide_split(xp: torch.Tensor, packed: torch.Tensor, b_hn: torch.Tensor,
                              h0: torch.Tensor, plan: WidePlan) -> torch.Tensor:
    """K8's wide path in its summation order (:func:`wide_dots`) from
    :func:`pack_wide`'s weights for the forward ``plan``: the same contract
    as :func:`gru_recurrence_plain` without saving. A model for the CPU
    tests."""
    hidden, u = plan.hidden, plan.units
    h, hs = h0, []
    for t in range(xp.shape[1]):
        pre = wide_dots(h, packed, plan)[..., : 3 * u].reshape(-1, plan.nchunk, 3, u)
        pre = pre.transpose(1, 2).reshape(-1, 3, plan.nchunk * u)[..., :hidden]
        xr, xz, xn = torch.split(xp[:, t], hidden, dim=-1)
        r = torch.sigmoid(xr + pre[:, 0])
        z = torch.sigmoid(xz + pre[:, 1])
        n = torch.tanh(xn + r * (pre[:, 2] + b_hn))
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def gru_backward_wide_split(g_ys: torch.Tensor, gates: torch.Tensor, ys: torch.Tensor,
                            h0: torch.Tensor, packed: torch.Tensor, plan: WidePlan):
    """K8b's wide path in its summation order (:func:`wide_dots` of each
    step's [dr^, dz^, d_hn] against the columns of W_hh, then ``+ z dh``)
    from :func:`pack_wide`'s weights for the backward ``plan``: the same
    contract as :func:`gru_backward_plain`. A model for the CPU tests."""
    hidden = plan.hidden
    carry = torch.zeros_like(h0)
    dxps, dhns = [], []
    for t in range(g_ys.shape[1] - 1, -1, -1):
        dh = carry + g_ys[:, t]
        r, z, n, hn = torch.split(gates[:, t], hidden, dim=-1)
        hp = ys[:, t - 1] if t > 0 else h0
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dz = dh * (hp - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        dhn = dn * r
        s = wide_dots(torch.cat([dr, dz, dhn], dim=-1), packed, plan)[..., : plan.units]
        carry = s.reshape(-1, plan.nchunk * plan.units)[:, :hidden] + z * dh
        dxps.append(torch.cat([dr, dz, dn], dim=-1))
        dhns.append(dhn)
    return torch.stack(dxps[::-1], dim=1), torch.stack(dhns[::-1], dim=1), carry


def folded_projection(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x W_ih^T + b_ih + [b_hr; b_hz; 0]`` (B, T, 3H): the hoisted input
    projection with the hidden bias's additive halves folded in (they add to
    the input's inside the r and z sigmoids; b_hn does not), as one addmm."""
    hidden = params["w_hh"].shape[-1]
    b_ih = params["b_ih"]
    bias = torch.cat([b_ih[: 2 * hidden] + params["b_hh"][: 2 * hidden], b_ih[2 * hidden:]])
    out = torch.addmm(bias, x.reshape(-1, x.shape[-1]), params["w_ih"].T)
    return out.reshape(*x.shape[:-1], 3 * hidden)


def gru_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor, b_hn: torch.Tensor,
                         h0: torch.Tensor, *, save: bool = False):
    """K8's arithmetic in torch, one step per loop iteration: ys (B, T, H),
    and with ``save`` also the gates (B, T, 4H) K8 saves for K8b: r, z, n
    and ``hn = h W_hn^T + b_hn`` of each step."""
    hidden = h0.shape[-1]
    h, hs, gs = h0, [], []
    for t in range(xp.shape[1]):
        hp = h @ w_hh.T
        xr, xz, xn = torch.split(xp[:, t], hidden, dim=-1)
        r = torch.sigmoid(xr + hp[:, :hidden])
        z = torch.sigmoid(xz + hp[:, hidden: 2 * hidden])
        hn = hp[:, 2 * hidden:] + b_hn
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        hs.append(h)
        if save:
            gs.append(torch.cat([r, z, n, hn], dim=-1))
    ys = torch.stack(hs, dim=1)
    return (ys, torch.stack(gs, dim=1)) if save else ys


def gru_backward_plain(g_ys: torch.Tensor, gates: torch.Tensor, ys: torch.Tensor,
                       h0: torch.Tensor, w_hh: torch.Tensor):
    """K8b's arithmetic in torch, one reverse step per loop iteration: the
    VJP of the recurrence given the cotangent of every ys step ``g_ys`` (B,
    T, H) and the saved ``gates`` -> (dxp (B, T, 3H) = [dr^, dz^, dn^],
    d_hn (B, T, H), dh0 (B, H)). dr^, dz^, dn^ are the gradients of the
    gates' pre-activations, d_hn that of ``h W_hn^T + b_hn``."""
    hidden = h0.shape[-1]
    carry = torch.zeros_like(h0)
    dxps, dhns = [], []
    for t in range(g_ys.shape[1] - 1, -1, -1):
        dh = carry + g_ys[:, t]
        r, z, n, hn = torch.split(gates[:, t], hidden, dim=-1)
        hp = ys[:, t - 1] if t > 0 else h0
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dz = dh * (hp - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        dhn = dn * r
        carry = torch.cat([dr, dz, dhn], dim=-1) @ w_hh + z * dh
        dxps.append(torch.cat([dr, dz, dn], dim=-1))
        dhns.append(dhn)
    return torch.stack(dxps[::-1], dim=1), torch.stack(dhns[::-1], dim=1), carry


def _check(xp, w_hh, b_hn, h0) -> None:
    tensors = (xp, w_hh, b_hn, h0)
    if xp.device.type != "cuda" or any(a.device != xp.device for a in tensors):
        raise ValueError(f"xp, w_hh, b_hn and h0 must be on one CUDA device, got "
                         f"{[str(a.device) for a in tensors]}")
    if any(a.dtype != torch.float32 for a in tensors):
        raise TypeError(f"xp, w_hh, b_hn and h0 must be float32, got {[a.dtype for a in tensors]}")
    b, steps, g3 = xp.shape
    hidden = g3 // 3
    if (g3 != 3 * hidden or tuple(w_hh.shape) != (g3, hidden) or tuple(b_hn.shape) != (hidden,)
            or tuple(h0.shape) != (b, hidden)):
        raise ValueError(
            f"want xp (B, T, 3H), w_hh (3H, H), b_hn (H,), h0 (B, H), got {tuple(xp.shape)}, "
            f"{tuple(w_hh.shape)}, {tuple(b_hn.shape)}, {tuple(h0.shape)}"
        )
    if hidden < 1 or steps < 1:
        raise ValueError(f"the kernel takes H >= 1 and T >= 1, got H = {hidden}, T = {steps}")
    if not all(a.is_contiguous() for a in (xp, b_hn, h0)):
        raise ValueError("xp, b_hn and h0 must be contiguous")


def _wide(rows: int, hidden: int, backward: bool, device: torch.device) -> WidePlan:
    """The wide plan at this shape, or a ValueError naming what it cannot
    hold on the card."""
    plan = wide_plan(rows, hidden, backward)
    props = torch.cuda.get_device_properties(device)
    if not plan.holds or plan.smem > props.shared_memory_per_block_optin \
            or plan.nchunk > props.multi_processor_count:
        raise ValueError(
            f"{'K8b' if backward else 'K8'}'s wide plan cannot hold B = {rows}, H = {hidden}: "
            f"{plan.ncg * plan.ks} warps of 16, {plan.smem} B of shared memory a CTA (the card "
            f"gives {props.shared_memory_per_block_optin}), {plan.nchunk} co-resident CTAs "
            f"({props.multi_processor_count} SMs)")
    return plan


def _exchange(plan: WidePlan, device: torch.device, h0: torch.Tensor | None = None):
    """The wide path's zeroed exchange, (2, R, kp) 64-bit words (tagged) or
    floats, with ``h0`` in slot 0 (words of step 0), and its counter: one
    allocation."""
    n = (2 if plan.tagged else 1) * 2 * plan.rows * plan.kp
    raw = torch.zeros(n + 4, dtype=torch.int32, device=device)
    if h0 is not None:
        hidden = h0.shape[-1]
        if plan.tagged:
            slot = raw[:n].view(torch.int64).reshape(2, plan.rows, plan.kp)
            slot[0, :, :hidden] = h0.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        else:
            raw[:n].view(torch.float32).reshape(2, plan.rows, plan.kp)[0, :, :hidden] = h0
    return raw, raw[n:]


def _plan_args(plan: WidePlan, t_steps: int) -> tuple:
    """The plan's ints in the order the C entries take them."""
    return (plan.rows, t_steps, plan.hidden, plan.units, plan.nchunk, plan.kp, plan.cw, plan.ncg,
            plan.ks, plan.pps, plan.jreg, int(plan.tagged))


def wide_forward(lib: ctypes.CDLL, plan: WidePlan, xp: torch.Tensor, w_hh: torch.Tensor,
                 b_hn: torch.Tensor, h0: torch.Tensor, ys: torch.Tensor,
                 gates: torch.Tensor | None) -> int:
    """Launch K8's wide path from ``lib`` (a build of ``csrc/gru_wide.cu``)
    on checked inputs; -> the cudaError_t."""
    buf, counter = _exchange(plan, xp.device, h0)
    return lib.aec_gru_wide_forward(
        _build.ptr(packed_wide(w_hh, plan)), _build.ptr(xp), _build.ptr(b_hn), _build.ptr(h0),
        _build.ptr(ys), None if gates is None else _build.ptr(gates), _build.ptr(buf),
        _build.ptr(counter), *_plan_args(plan, xp.shape[1]), xp.device.index,
        _build.stream_of(xp))


def wide_backward(lib: ctypes.CDLL, plan: WidePlan, g_ys: torch.Tensor, gates: torch.Tensor,
                  ys: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, dxp: torch.Tensor,
                  dhn: torch.Tensor, dh0: torch.Tensor) -> int:
    """Launch K8b's wide path from ``lib`` on checked inputs; -> the
    cudaError_t."""
    buf, counter = _exchange(plan, ys.device)
    return lib.aec_gru_wide_backward(
        _build.ptr(packed_wide(w_hh, plan)), _build.ptr(g_ys), _build.ptr(gates), _build.ptr(ys),
        _build.ptr(h0), _build.ptr(dxp), _build.ptr(dhn), _build.ptr(dh0), _build.ptr(buf),
        _build.ptr(counter), *_plan_args(plan, ys.shape[1]), ys.device.index,
        _build.stream_of(ys))


def gru_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hn: torch.Tensor,
                   h0: torch.Tensor, *, save: bool = False):
    """The GRU recurrence over a folded input projection ``xp`` (B, T, 3H)
    (:func:`folded_projection`), ``w_hh`` (3H, H), ``b_hn`` (H,) and ``h0``
    (B, H) -> ys (B, T, H); with ``save`` also the gates (B, T, 4H) that
    :func:`gru_backward` takes.

    A CUDA tensor launches K8 (or raises: not fp32, not contiguous, T = 0,
    on the wide path a shape its plan cannot hold); a CPU tensor takes the
    plain recurrence. H <= 128 runs one CTA per row with W_hh in registers,
    a wider H the wide path (counted also in ``gru_recurrence.wide_launches``).
    """
    hidden = h0.shape[-1]
    if xp.device.type == "cpu":
        return gru_recurrence_plain(xp, w_hh, b_hn, h0, save=save)
    _check(xp, w_hh, b_hn, h0)
    b, t = xp.shape[0], xp.shape[1]
    ys = xp.new_empty((b, t, hidden))
    gates = xp.new_empty((b, t, 4 * hidden)) if save else None
    if hidden <= MAX_HIDDEN:
        err = _lib().aec_gru(
            _build.ptr(xp), _build.ptr(packed_lanes(w_hh)), _build.ptr(b_hn), _build.ptr(h0),
            _build.ptr(ys), _build.ptr(gates) if save else None, b, t, hidden, xp.device.index,
            _build.stream_of(xp),
        )
    else:
        err = wide_forward(_wide_lib(), _wide(b, hidden, False, xp.device), xp, w_hh, b_hn, h0,
                           ys, gates)
    _build.check(err, "gru")
    gru_recurrence.launches += 1
    if hidden > MAX_HIDDEN:
        gru_recurrence.wide_launches += 1
    return (ys, gates) if save else ys


gru_recurrence.launches = 0
gru_recurrence.wide_launches = 0


def gru_backward(g_ys: torch.Tensor, gates: torch.Tensor, ys: torch.Tensor, h0: torch.Tensor,
                 w_hh: torch.Tensor):
    """The recurrence's VJP (:func:`gru_backward_plain`'s contract): ``g_ys``
    and ``ys`` (B, T, H), ``gates`` (B, T, 4H) from ``gru_recurrence(...,
    save=True)``, ``h0`` (B, H), ``w_hh`` (3H, H) -> (dxp, d_hn, dh0).

    A CUDA tensor launches K8b (or raises: not fp32, not contiguous, T = 0,
    on the wide path, H > 128, a shape its plan cannot hold); a CPU tensor
    takes the plain loop. The wide path's launches are counted also in
    ``gru_backward.wide_launches``.
    """
    if g_ys.device.type == "cpu":
        return gru_backward_plain(g_ys, gates, ys, h0, w_hh)
    b, t, hidden = ys.shape
    tensors = (g_ys, gates, ys, h0, w_hh)
    if any(a.device != g_ys.device for a in tensors):
        raise ValueError(f"g_ys, gates, ys, h0 and w_hh must be on one CUDA device, got "
                         f"{[str(a.device) for a in tensors]}")
    if any(a.dtype != torch.float32 for a in tensors):
        raise TypeError(f"g_ys, gates, ys, h0 and w_hh must be float32, got "
                        f"{[a.dtype for a in tensors]}")
    if (tuple(g_ys.shape) != (b, t, hidden) or tuple(gates.shape) != (b, t, 4 * hidden)
            or tuple(h0.shape) != (b, hidden) or tuple(w_hh.shape) != (3 * hidden, hidden)):
        raise ValueError(
            f"want g_ys, ys (B, T, H), gates (B, T, 4H), h0 (B, H), w_hh (3H, H), got "
            f"{tuple(g_ys.shape)}, {tuple(ys.shape)}, {tuple(gates.shape)}, {tuple(h0.shape)}, "
            f"{tuple(w_hh.shape)}")
    if hidden < 1 or t < 1:
        raise ValueError(f"K8b takes H >= 1 and T >= 1, got H = {hidden}, T = {t}")
    if not all(a.is_contiguous() for a in tensors[:4]):
        raise ValueError("g_ys, gates, ys and h0 must be contiguous")
    dxp = ys.new_empty((b, t, 3 * hidden))
    dhn, dh0 = torch.empty_like(ys), torch.empty_like(h0)
    if hidden <= MAX_HIDDEN:
        err = _lib().aec_gru_backward(
            _build.ptr(g_ys), _build.ptr(gates), _build.ptr(ys), _build.ptr(h0),
            _build.ptr(packed_lanes(w_hh, transposed=True)), _build.ptr(dxp), _build.ptr(dhn),
            _build.ptr(dh0), b, t, hidden, ys.device.index, _build.stream_of(ys),
        )
    else:
        err = wide_backward(_wide_lib(), _wide(b, hidden, True, ys.device), g_ys, gates, ys, h0,
                            w_hh, dxp, dhn, dh0)
    _build.check(err, "gru_backward")
    gru_backward.launches += 1
    if hidden > MAX_HIDDEN:
        gru_backward.wide_launches += 1
    return dxp, dhn, dh0


gru_backward.launches = 0
gru_backward.wide_launches = 0


class GruScanFused(torch.autograd.Function):
    """``(x, h0, w_ih, w_hh, b_ih, b_hh, save) -> ys (B, T, H)``: forward
    through K8 (plain on the CPU), saving the gates where ``save`` (a
    gradient is wanted); backward through K8b (plain on the CPU) on them and
    the weight gradients as products over the B T rows."""

    @staticmethod
    def forward(ctx, x, h0, w_ih, w_hh, b_ih, b_hh, save):
        params = {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
        hidden = w_hh.shape[-1]
        xp = folded_projection(params, x)
        if save:
            ys, gates = gru_recurrence(xp, w_hh, b_hh[2 * hidden:], h0, save=True)
            ctx.save_for_backward(x, h0, w_ih, w_hh, ys, gates)
        else:
            ys = gru_recurrence(xp, w_hh, b_hh[2 * hidden:], h0)
        return ys

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:6]
        x, h0, w_ih, w_hh, ys, gates = ctx.saved_tensors
        b, t, hidden = ys.shape
        dxp, dhn, dh0 = gru_backward(g.contiguous(), gates, ys, h0, w_hh)
        rows = dxp.reshape(b * t, 3 * hidden)
        dx = dw_ih = db_ih = dw_hh = db_hh = None
        if need[0]:
            dx = dxp @ w_ih
        if need[2]:
            dw_ih = rows.T @ x.reshape(b * t, -1)
        if need[4]:
            db_ih = rows.sum(0)
        if need[3] or need[5]:
            # [dr^, dz^, d_hn]: b_hr, b_hz sit in the folded bias, b_hn in hn
            d_hh = torch.cat([dxp[..., : 2 * hidden], dhn], dim=-1).reshape(b * t, 3 * hidden)
            if need[3]:
                h_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1).reshape(b * t, hidden)
                dw_hh = d_hh.T @ h_prev
            if need[5]:
                db_hh = d_hh.sum(0)
        return dx, dh0 if need[1] else None, dw_ih, dw_hh, db_ih, db_hh, None


def gru_scan_fused(params: dict[str, torch.Tensor], x: torch.Tensor,
                   h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused GRU scan: ``[B, T, I] -> ([B, T, H], h_T)``, differentiable in
    ``x``, ``h0`` and the four parameters (``nn.GRU``'s own Parameters when
    called with ``LittleNet.gru_params()``). K8 saves the gates for K8b only
    where autograd records and some input needs a gradient."""
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], params["w_hh"].shape[-1]))
    inputs = (x, h0, params["w_ih"], params["w_hh"], params["b_ih"], params["b_hh"])
    save = torch.is_grad_enabled() and any(a.requires_grad for a in inputs)
    ys = GruScanFused.apply(*inputs, save)
    return ys, ys[:, -1]


def gru_scan_fused_plain(params: dict[str, torch.Tensor], x: torch.Tensor,
                         h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`gru_scan_fused`'s forward: the folded
    projection, then K8's arithmetic in torch."""
    hidden = params["w_hh"].shape[-1]
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], hidden))
    ys = gru_recurrence_plain(folded_projection(params, x), params["w_hh"],
                           params["b_hh"][2 * hidden:], h0)
    return ys, ys[:, -1]
