"""Kernels K8 and K8b: the GRU recurrence and its backward, one CUDA launch
each, differentiable.

K8 replaces ``aec_tpu/kernels/pallas_gru.py:65`` (``_gru_scan_fused_fwd``,
``pallas_call`` at ``:107``), K8b the backward of its custom VJP
``gru_scan_fused`` (``_bwd``, ``:159-166``). Both are ``csrc/gru.cu``: one
CTA per batch row walks the T steps with W_hh in registers (each hidden
unit's three gate rows, for K8b its three gate columns, split over a team
of lanes as :func:`pack_gru_lanes` lays them out) and a double-buffered
vector in shared memory; a serial recursion, so one step's latency bounds
it (the source's header has the reckoning). :func:`packed_lanes` caches
both packings keyed on W_hh's ``data_ptr()`` and ``_version`` (an entry
holds the tensor, so no other tensor can take its address while it lives):
an optimizer step or a ``copy_`` makes the next call pack again, an
in-place change through ``.data`` bypasses the version counter (call
:func:`clear_cache` after one).
:func:`gru_recurrence_split` is a plain-torch model of its summation order.
A net too wide for one SM (H > 128) takes the kernel's wide path: the same
recurrence on one persistent grid of co-resident CTAs
(``csrc/grid_scan.cuh``), each owning a few hidden units,
W_hh^T read from L2 every step.

:class:`GruScanFused` computes what the JAX custom VJP computes: its
forward is the hoisted input projection as one ``torch.addmm`` (``b_hr`` and
``b_hz`` folded into its bias, ``b_hn`` left inside the reset product)
followed by the recurrence on K8, which, when a gradient is wanted, also
saves each step's r, z, n and ``h W_hn^T + b_hn``; its backward runs K8b
on them and forms the weight gradients as plain products over the B T
rows. JAX's backward is ``jax.vjp`` of the scan, which XLA compiles into
one loop on the device; eager PyTorch runs a loop as ~10 launches a step,
so the port's counterpart of that compiled loop is a kernel. Above H = 128
(the wide path, no K8b yet) the backward recomputes the plain scan and
differentiates it. :func:`gru_recurrence` and :func:`gru_backward` are the
kernels' wrappers (a CUDA tensor launches the kernel or raises, a CPU
tensor takes :func:`gru_recurrence_plain` / :func:`gru_backward_plain`);
:func:`gru_scan_fused_plain` is the plain version of the whole forward.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict

import torch
import torch.nn.functional as F

from aec_tpu_torch.kernels import _build


# K8's and K8b's register path (``kMaxHidden`` in ``csrc/gru.cu``); wider
# nets run K8's wide path and recompute in the backward
MAX_HIDDEN = 128
CACHE_SIZE = 8  # packed W_hh kept: a net's K8 and K8b layouts, a few nets
_PACKED: OrderedDict = OrderedDict()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_gru.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.aec_gru.restype = ctypes.c_int
    lib.aec_gru_backward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.aec_gru_backward.restype = ctypes.c_int
    lib.aec_gru_max_hidden.restype = ctypes.c_int
    lib.aec_gru_units.argtypes = [i, i, i]
    lib.aec_gru_units.restype = ctypes.c_int
    lib.aec_gru_grid.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.aec_gru_grid.restype = ctypes.c_int
    return lib


def pack_gate_columns(w_hh: torch.Tensor, gates: int, units: int) -> torch.Tensor:
    """``W_hh`` (G, gates H, H) -> (G, nchunk, H, gates U): for each CTA of a
    grid recurrence (``csrc/grid_scan.cuh``) the gate columns of W_hh^T of
    its U hidden units, contiguous; units past H are zero columns."""
    g, _, hidden = w_hh.shape
    nchunk = -(-hidden // units)
    w = F.pad(w_hh.reshape(g, gates, hidden, hidden), (0, 0, 0, nchunk * units - hidden))
    w = w.reshape(g, gates, nchunk, units, hidden).permute(0, 2, 4, 1, 3)
    return w.reshape(g, nchunk, hidden, gates * units).contiguous()


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


def packed_lanes(w_hh: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    """:func:`pack_gru_lanes` of ``w_hh`` (K8's registers) or, with
    ``transposed``, of its per-gate transpose (K8b's), cached keyed on the
    tensor's ``data_ptr()`` and ``_version`` (the entry holds the tensor)."""
    key = (w_hh.data_ptr(), w_hh._version, tuple(w_hh.shape), w_hh.dtype, w_hh.device,
           transposed)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[0]
    w = w_hh.detach()
    if transposed:
        hidden = w.shape[-1]
        w = w.reshape(3, hidden, hidden).transpose(1, 2).reshape(3 * hidden, hidden)
    _PACKED[key] = (pack_gru_lanes(w), w_hh)
    while len(_PACKED) > CACHE_SIZE:
        _PACKED.popitem(last=False)
    return _PACKED[key][0]


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


def gru_recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hn: torch.Tensor,
                   h0: torch.Tensor, *, save: bool = False):
    """The GRU recurrence over a folded input projection ``xp`` (B, T, 3H)
    (:func:`folded_projection`), ``w_hh`` (3H, H), ``b_hn`` (H,) and ``h0``
    (B, H) -> ys (B, T, H); with ``save`` (H <= 128) also the gates (B, T,
    4H) that :func:`gru_backward` takes.

    A CUDA tensor launches K8 (or raises: not fp32, not contiguous, T = 0,
    a grid the card cannot hold co-resident on the wide path); a CPU tensor
    takes the plain recurrence. H <= 128 runs one CTA per row with W_hh in
    registers, a wider H the wide path.
    """
    hidden = h0.shape[-1]
    if save and hidden > MAX_HIDDEN:
        raise ValueError(f"only K8's register path (H <= {MAX_HIDDEN}) saves gates, got H = {hidden}")
    if xp.device.type == "cpu":
        return gru_recurrence_plain(xp, w_hh, b_hn, h0, save=save)
    lib = _lib()
    _check(xp, w_hh, b_hn, h0)
    b, t = xp.shape[0], xp.shape[1]
    dev = xp.device.index
    ys = xp.new_empty((b, t, hidden))
    gates = xp.new_empty((b, t, 4 * hidden)) if save else None
    if hidden <= MAX_HIDDEN:
        wpk = packed_lanes(w_hh)
        err = lib.aec_gru(
            _build.ptr(xp), _build.ptr(wpk), _build.ptr(b_hn), _build.ptr(h0), _build.ptr(ys),
            _build.ptr(gates) if save else None, b, t, hidden, dev, _build.stream_of(xp),
        )
    else:
        units = lib.aec_gru_units(b, hidden, dev)
        wp = pack_gate_columns(w_hh.detach()[None], 3, units)
        hbuf = xp.new_zeros((2, b, hidden))
        hbuf[0] = h0
        err = lib.aec_gru_grid(
            _build.ptr(xp), _build.ptr(wp), _build.ptr(b_hn), _build.ptr(hbuf), _build.ptr(ys),
            b, t, hidden, units, dev, _build.stream_of(xp),
        )
    _build.check(err, "gru")
    gru_recurrence.launches += 1
    return (ys, gates) if save else ys


gru_recurrence.launches = 0


def gru_backward(g_ys: torch.Tensor, gates: torch.Tensor, ys: torch.Tensor, h0: torch.Tensor,
                 w_hh: torch.Tensor):
    """The recurrence's VJP (:func:`gru_backward_plain`'s contract): ``g_ys``
    and ``ys`` (B, T, H), ``gates`` (B, T, 4H) from ``gru_recurrence(...,
    save=True)``, ``h0`` (B, H), ``w_hh`` (3H, H) -> (dxp, d_hn, dh0).

    A CUDA tensor launches K8b (or raises: not fp32, not contiguous, H >
    128, T = 0); a CPU tensor takes the plain loop.
    """
    if g_ys.device.type == "cpu":
        return gru_backward_plain(g_ys, gates, ys, h0, w_hh)
    lib = _lib()
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
    if not 1 <= hidden <= MAX_HIDDEN or t < 1:
        raise ValueError(f"K8b takes 1 <= H <= {MAX_HIDDEN} and T >= 1, got H = {hidden}, T = {t}")
    if not all(a.is_contiguous() for a in tensors[:4]):
        raise ValueError("g_ys, gates, ys and h0 must be contiguous")
    wpk_t = packed_lanes(w_hh, transposed=True)
    dxp = ys.new_empty((b, t, 3 * hidden))
    dhn, dh0 = torch.empty_like(ys), torch.empty_like(h0)
    err = lib.aec_gru_backward(
        _build.ptr(g_ys), _build.ptr(gates), _build.ptr(ys), _build.ptr(h0), _build.ptr(wpk_t),
        _build.ptr(dxp), _build.ptr(dhn), _build.ptr(dh0), b, t, hidden, ys.device.index,
        _build.stream_of(ys),
    )
    _build.check(err, "gru_backward")
    gru_backward.launches += 1
    return dxp, dhn, dh0


gru_backward.launches = 0


class GruScanFused(torch.autograd.Function):
    """``(x, h0, w_ih, w_hh, b_ih, b_hh, save) -> ys (B, T, H)``: forward
    through K8 (plain on the CPU), saving the gates where ``save`` (a
    gradient is wanted and H <= 128); backward through K8b (plain on the
    CPU) and the weight gradients as products over the B T rows, or, on the
    wide path, by recomputing the plain scan."""

    @staticmethod
    def forward(ctx, x, h0, w_ih, w_hh, b_ih, b_hh, save):
        params = {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
        hidden = w_hh.shape[-1]
        xp = folded_projection(params, x)
        ctx.saved_gates = save
        if save:
            ys, gates = gru_recurrence(xp, w_hh, b_hh[2 * hidden:], h0, save=True)
            ctx.save_for_backward(x, h0, w_ih, w_hh, ys, gates)
        else:
            ys = gru_recurrence(xp, w_hh, b_hh[2 * hidden:], h0)
            ctx.save_for_backward(x, h0, w_ih, w_hh, b_ih, b_hh)
        return ys

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:6]
        if not ctx.saved_gates:
            return (*_recompute_grads(ctx.saved_tensors, need, g), None)
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


def _recompute_grads(saved, need, g) -> list:
    """The wide path's backward: the plain scan recomputed and differentiated."""
    from aec_tpu_torch.ops.gru import gru_scan

    leaves = [t.detach().requires_grad_() for t in saved]
    x, h0, w_ih, w_hh, b_ih, b_hh = leaves
    with torch.enable_grad():
        ys, _ = gru_scan({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}, x, h0,
                         fused=False)
        grads = iter(torch.autograd.grad(ys, [t for t, n in zip(leaves, need) if n], g))
    return [next(grads) if n else None for n in need]


def gru_scan_fused(params: dict[str, torch.Tensor], x: torch.Tensor,
                   h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused GRU scan: ``[B, T, I] -> ([B, T, H], h_T)``, differentiable in
    ``x``, ``h0`` and the four parameters (``nn.GRU``'s own Parameters when
    called with ``LittleNet.gru_params()``). K8 saves the gates for K8b only
    where autograd records and some input needs a gradient."""
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], params["w_hh"].shape[-1]))
    inputs = (x, h0, params["w_ih"], params["w_hh"], params["b_ih"], params["b_hh"])
    save = (torch.is_grad_enabled() and any(a.requires_grad for a in inputs)
            and params["w_hh"].shape[-1] <= MAX_HIDDEN)
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
