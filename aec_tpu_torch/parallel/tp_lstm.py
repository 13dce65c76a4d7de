"""Tensor-parallel LSTM scan: the recurrent weights sharded over the ranks
of a mesh axis (``aec_tpu/parallel/tp_lstm.py``).

ATT-CCRN's bottleneck is a 4096-unit LSTM whose step at batch 1 is bound
by streaming ``w_hh`` (268 MB in fp32). Sharding the gate rows over D
ranks makes each rank stream 1/D of it a step and exchange only the hidden
state (B * H floats).

Layout (Megatron's column-parallel recipe on a recurrence), as JAX's:

- H is split into D contiguous shards; shard d owns hidden slice
  ``h[d*H/D:(d+1)*H/D]`` and the rows of ``w_ih`` / ``w_hh`` / the biases
  that produce that slice of all four gates (rows [i; f; g; o], so the
  owned rows are gate-strided: :func:`_gate_perm`);
- each step a rank computes ``gates = xp_t + h_full @ w_hh_local^T`` (the
  contraction over the full H, no partial sums, so the numbers are the
  dense scan's), updates its c / h slices, and an all-gather over the axis
  reassembles ``h_full`` for the next step;
- the input projection and both biases are hoisted out of the loop, each
  rank projecting onto its own gate rows.

JAX computes this scan in plain ``jnp`` (no Pallas kernel), so the port's
step is plain torch too: a ``torch.matmul`` and the cell, on any device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from aec_tpu_torch.ops.lstm import _recurrent_dtype, lstm_gates


def _gate_perm(hidden: int, n_shards: int) -> np.ndarray:
    """Row permutation putting shard d's [i;f;g;o] slices contiguous.

    Shard d of the permuted (4H,)-row array holds, for each gate g in
    [i,f,g,o], original rows ``g*H + d*H/D + [0..H/D)``: the gate rows
    producing hidden slice d.
    """
    hp = hidden // n_shards
    return np.concatenate(
        [g * hidden + d * hp + np.arange(hp) for d in range(n_shards) for g in range(4)]
    )


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _Replicate(torch.autograd.Function):
    """Identity forward on an input every rank of the group holds whole;
    the backward sums the ranks' partial cotangents (each rank's reaches
    the input through its own gate rows only), so the gradient comes out
    whole on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherSum(torch.autograd.Function):
    """All-gather of the ranks' last-axis slices; the backward is a
    reduce-scatter of the cotangents (each rank's cotangent of the whole is
    partial: the next step's gates of its own rows, or its share of one
    loss), done as an all-reduce and this rank's slice, which gloo can run."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index, ctx.width = group, index, x.shape[-1]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather whose result feeds work every rank repeats whole (a loss
    every rank computes alike): the cotangents agree, so each rank keeps
    its slice."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.width = index, x.shape[-1]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None


def _axis_group(mesh, axis: str):
    """The process group of ``axis``, or None where the axis has one rank
    (no group, or a group of one): the scan then runs no collective."""
    return mesh.group(axis) if mesh.shape[axis] > 1 else None


def gather_replicated(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """This rank's last-axis slice of a tensor sharded over ``axis`` (the
    ``ys`` of :func:`lstm_scan_tp`) -> the whole tensor, for work every rank
    of the axis then repeats whole (ATT-CCRN's decoder and loss)."""
    group = _axis_group(mesh, axis)
    return x if group is None else _GatherReplicated.apply(x, group, mesh.index(axis))


def lstm_scan_tp(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    mesh,
    axis: str = "model",
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
    recurrent_dtype=None,
):
    """[B, T, I] -> (ys [B, T, H/D], (h_T [B, H], c_T [B, H])), the gate rows
    sharded over the ranks of ``axis`` (D of them).

    The contract and gate math of ``ops.lstm.lstm_scan`` (torch semantics),
    with both biases summed once as JAX's scan sums them; H must divide by
    D. ``x`` (and ``h0`` / ``c0``) are replicated: every rank of the axis
    passes them whole (a separate data axis shards the batch as usual).
    Returned: this rank's slice ``ys[..., d*H/D:(d+1)*H/D]`` of the outputs
    (JAX's out_spec ``P(None, None, axis)``) and the final states whole on
    every rank.

    ``recurrent_dtype`` is ``lstm_scan``'s float cast of h and W_hh for the
    recurrent product; None is fp32, what ``lstm_scan`` takes on the card
    (JAX's bf16 default is for the TPU only). The int8 stream has no
    tensor-parallel form and is refused.

    Gradients: those of ``x``, ``h0`` and ``c0`` come out whole on every
    rank; each weight's gradient holds this rank's gate rows (zeros
    elsewhere), so a sum over the axis assembles the dense one. A loss on
    ``ys`` / ``h_T`` / ``c_T`` is each rank's share of one loss (on ``ys``:
    the terms of its slice), as the data-parallel steps take it. On an
    axis of one rank the scan runs no collective.
    """
    b, t, _ = x.shape
    hidden = params["w_hh"].shape[-1]
    d = mesh.shape[axis]
    if hidden % d:
        raise ValueError(f"hidden={hidden} not divisible by mesh axis {axis}={d}")
    rdt = _recurrent_dtype(recurrent_dtype)
    if rdt == "int8":
        raise ValueError("the tensor-parallel scan has no int8 stream; use a float "
                         "recurrent_dtype or None")
    hp = hidden // d
    group, idx = _axis_group(mesh, axis), mesh.index(axis)
    if h0 is None:
        h0 = x.new_zeros((b, hidden))
    if c0 is None:
        c0 = x.new_zeros((b, hidden))
    if group is not None:
        x, h0, c0 = (_Replicate.apply(v, group) for v in (x, h0, c0))

    rows = torch.as_tensor(_gate_perm(hidden, d)[idx * 4 * hp:(idx + 1) * 4 * hp],
                           device=x.device)
    w_ih = params["w_ih"][rows]
    w_hh_t = params["w_hh"][rows].T
    bias = (params["b_ih"] + params["b_hh"])[rows]
    x_proj = torch.matmul(x, w_ih.T) + bias  # (B, T, 4H/D)
    if rdt is not None:
        w_hh_t = w_hh_t.to(rdt).to(x.dtype)  # cast once

    def gather(v):
        return v if group is None else _GatherSum.apply(v, group, idx)

    h_full, c = h0, c0[:, idx * hp:(idx + 1) * hp]
    hs = []
    for i in range(t):
        h_in = h_full if rdt is None else h_full.to(rdt).to(x.dtype)
        h_l, c = lstm_gates(x_proj[:, i] + torch.matmul(h_in, w_hh_t), c)
        hs.append(h_l)
        # shard order == original order, by construction of _gate_perm
        h_full = gather(h_l)
    ys = torch.stack(hs, dim=1) if hs else x.new_zeros((b, 0, hp))
    return ys, (h_full, gather(c))


def shard_lstm_params(params: dict[str, torch.Tensor], mesh, axis: str = "model"):
    """This rank's gate rows of ``w_ih`` / ``w_hh`` in the canonical row
    order, the other ranks' rows zeroed; the biases whole.

    Optional, as in JAX: :func:`lstm_scan_tp` takes replicated params and
    reads only its own rows, so the scan gives the same numbers on either.
    JAX places each row shard on its device; here the zeroed rows mark
    what this rank does not own (the tensors keep their full shape)."""
    hidden = params["w_hh"].shape[-1]
    d, idx = mesh.shape[axis], mesh.index(axis)
    hp = hidden // d
    rows = torch.as_tensor(_gate_perm(hidden, d)[idx * 4 * hp:(idx + 1) * 4 * hp],
                           device=params["w_hh"].device)
    out = dict(params)
    for k in ("w_ih", "w_hh"):
        w = torch.zeros_like(params[k])
        w[rows] = params[k][rows]
        out[k] = w
    return out
