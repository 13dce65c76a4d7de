"""Kernel K8: the GRU recurrence as one CUDA launch, differentiable.

Replaces ``aec_tpu/kernels/pallas_gru.py:65`` (``_gru_scan_fused_fwd``,
``pallas_call`` at ``:107``) and its custom VJP ``gru_scan_fused``
(``:141-169``). The kernel is ``csrc/gru.cu``: one CTA per batch row walks
the T steps with W_hh in registers (each hidden unit's three gate rows
split over a team of lanes, packed per call by :func:`pack_gru_lanes`) and
h double-buffered in shared memory; a serial recursion, so one step's
latency bounds it (the source's header has the reckoning).
:func:`gru_recurrence_split` is a plain-torch model of its summation order.
A net too wide for one SM (H > 128) takes the kernel's wide path: the same
recurrence on one persistent grid of co-resident CTAs
(``csrc/grid_scan.cuh``), each owning a few hidden units,
W_hh^T read from L2 every step.

:class:`GruScanFused` does what the JAX custom VJP does: its forward is the
hoisted input projection as one ``torch.matmul`` (``b_hr`` and ``b_hz``
folded into its bias, ``b_hn`` left inside the reset product) followed by
the recurrence on K8; its backward recomputes through the plain
``ops.gru.gru_scan`` and differentiates that. JAX has no backward kernel, so
neither has the port. :func:`gru_recurrence` is the kernel's wrapper (a
CUDA tensor launches K8 or raises, a CPU tensor takes the plain recurrence);
:func:`gru_scan_fused_plain` is the plain version of the whole forward.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from aec_tpu_torch.kernels import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aec_gru.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.aec_gru.restype = ctypes.c_int
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
    i) + e]``, e < 4, zero past H (:func:`lane_plan`). One op chain per call,
    never per step."""
    hidden = w_hh.shape[-1]
    p, c, units = lane_plan(hidden)
    w = w_hh.reshape(3, hidden, hidden)
    if (p * c, units) != (hidden, hidden):
        w = F.pad(w, (0, p * c - hidden, 0, units - hidden))
    w = w.reshape(3, units, c // 4, p, 4).permute(0, 2, 1, 3, 4)  # [g, i, j, l, e]
    return w.reshape(3 * c // 4, units * p, 4).contiguous()


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


def folded_projection(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x W_ih^T + b_ih + [b_hr; b_hz; 0]`` (B, T, 3H): the hoisted input
    projection with the hidden bias's additive halves folded in (they add to
    the input's inside the r and z sigmoids; b_hn does not)."""
    hidden = params["w_hh"].shape[-1]
    b_hh = params["b_hh"]
    bias = params["b_ih"] + torch.cat([b_hh[: 2 * hidden], torch.zeros_like(b_hh[2 * hidden:])])
    return torch.matmul(x, params["w_ih"].T) + bias


def gru_recurrence_plain(xp: torch.Tensor, w_hh: torch.Tensor, b_hn: torch.Tensor,
                      h0: torch.Tensor) -> torch.Tensor:
    """K8's arithmetic in torch, one step per loop iteration."""
    hidden = h0.shape[-1]
    h, hs = h0, []
    for t in range(xp.shape[1]):
        hp = h @ w_hh.T
        xr, xz, xn = torch.split(xp[:, t], hidden, dim=-1)
        r = torch.sigmoid(xr + hp[:, :hidden])
        z = torch.sigmoid(xz + hp[:, hidden: 2 * hidden])
        n = torch.tanh(xn + r * (hp[:, 2 * hidden:] + b_hn))
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


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
                   h0: torch.Tensor) -> torch.Tensor:
    """The GRU recurrence over a folded input projection ``xp`` (B, T, 3H)
    (:func:`folded_projection`), ``w_hh`` (3H, H), ``b_hn`` (H,) and ``h0``
    (B, H) -> ys (B, T, H).

    A CUDA tensor launches K8 (or raises: not fp32, not contiguous, T = 0,
    a grid the card cannot hold co-resident on the wide path); a CPU tensor
    takes the plain recurrence. H <= 128 runs one CTA per row with W_hh in
    registers, a wider H the wide path.
    """
    if xp.device.type == "cpu":
        return gru_recurrence_plain(xp, w_hh, b_hn, h0)
    lib = _lib()
    _check(xp, w_hh, b_hn, h0)
    b, t, hidden = xp.shape[0], xp.shape[1], h0.shape[-1]
    dev = xp.device.index
    ys = xp.new_empty((b, t, hidden))
    if hidden <= lib.aec_gru_max_hidden():
        wpk = pack_gru_lanes(w_hh.detach())  # held until the launch is enqueued
        err = lib.aec_gru(
            _build.ptr(xp), _build.ptr(wpk), _build.ptr(b_hn), _build.ptr(h0), _build.ptr(ys),
            b, t, hidden, dev, _build.stream_of(xp),
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
    return ys


gru_recurrence.launches = 0


class GruScanFused(torch.autograd.Function):
    """``(x, h0, w_ih, w_hh, b_ih, b_hh) -> ys (B, T, H)``: forward through
    K8 (plain on the CPU), backward by recomputing the plain scan."""

    @staticmethod
    def forward(ctx, x, h0, w_ih, w_hh, b_ih, b_hh):
        params = {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
        hidden = w_hh.shape[-1]
        ys = gru_recurrence(folded_projection(params, x), w_hh, b_hh[2 * hidden:], h0)
        ctx.save_for_backward(x, h0, w_ih, w_hh, b_ih, b_hh)
        return ys

    @staticmethod
    def backward(ctx, g):
        from aec_tpu_torch.ops.gru import gru_scan

        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        x, h0, w_ih, w_hh, b_ih, b_hh = leaves
        with torch.enable_grad():
            ys, _ = gru_scan({"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}, x, h0,
                             fused=False)
            need = [t for t, n in zip(leaves, ctx.needs_input_grad) if n]
            grads = iter(torch.autograd.grad(ys, need, g))
        return tuple(next(grads) if n else None for n in ctx.needs_input_grad)


def gru_scan_fused(params: dict[str, torch.Tensor], x: torch.Tensor,
                   h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused GRU scan: ``[B, T, I] -> ([B, T, H], h_T)``, differentiable in
    ``x``, ``h0`` and the four parameters (``nn.GRU``'s own Parameters when
    called with ``LittleNet.gru_params()``)."""
    if h0 is None:
        h0 = x.new_zeros((x.shape[0], params["w_hh"].shape[-1]))
    ys = GruScanFused.apply(x, h0, params["w_ih"], params["w_hh"], params["b_ih"], params["b_hh"])
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
