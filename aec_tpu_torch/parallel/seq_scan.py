"""Sequence-parallel (pipelined) scan over the ranks of a mesh axis
(``aec_tpu/parallel/seq_scan.py``).

The framework's recurrences (GRU state, adaptive-filter state) are
nonlinear, so one sequence cannot be split associatively. Where the frame
axis must be sharded (memory, or frames that live with other sharded
tensors), the sequences flow through a pipeline of ranks, GPipe-style:

- the frame axis T is split into n contiguous chunks, chunk i on rank i;
- in round p, rank i scans chunk i of sequence p - i, then hands its carry
  to rank i + 1 (point-to-point send / recv; zeros when it had no
  sequence that round, as JAX's ``ppermute`` of an inactive stage);
- after S + n - 1 rounds every sequence has crossed every chunk; the
  outputs stay where they were computed ([S, T/n] per rank) and the final
  carries come off the last rank to every rank.

Plain data parallelism over utterances is the better layout for the AEC
workload (the recurrent state is O(1) in T) and stays the default; this is
the long-sequence primitive.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def _stack(trees: list) -> Any:
    """Pytrees of one structure -> one pytree, each leaf stacked on axis 0."""
    spec = pytree.tree_flatten(trees[0])[1]
    cols = zip(*(pytree.tree_flatten(tree)[0] for tree in trees))
    return pytree.tree_unflatten([torch.stack(col) for col in cols], spec)


def scan(step_fn: Callable, carry: Any, xs: Any) -> tuple[Any, Any]:
    """``lax.scan`` over axis 0 of the pytree ``xs``: ``step_fn(carry, x_t)
    -> (carry, y_t)``; the ``y_t`` stacked on a new axis 0. At least one
    step."""
    leaves, spec = pytree.tree_flatten(xs)
    ys = []
    for i in range(leaves[0].shape[0]):
        carry, y = step_fn(carry, pytree.tree_unflatten([a[i] for a in leaves], spec))
        ys.append(y)
    return carry, _stack(ys)


def pipelined_scan(
    step_fn: Callable[[Any, Any], tuple[Any, Any]],
    init_state: Any,
    xs: Any,
    mesh,
    axis: str = "data",
):
    """Scan ``step_fn`` over axis 1 (frames) of ``xs`` (leading axis =
    sequences), the frames split over the ranks of ``axis`` and the
    sequences pipelined through them.

    step_fn: (state, x_t) -> (state, y_t), ``lax.scan``'s contract.
    xs: pytree of [S, T, ...], the same on every rank of the axis; T must
    divide by the axis size n. Every rank of the axis calls this alike.
    Returns (ys, finals): ``ys`` this rank's frames of every sequence, a
    pytree of [S, T/n, ...] (rank i holds frames [i*T/n, (i+1)*T/n), JAX's
    ``P(None, axis)``), and ``finals`` the sequences' final states, a
    pytree of [S, ...] the same on every rank.
    """
    n, group, idx = mesh.shape[axis], mesh.group(axis), mesh.index(axis)
    ranks = mesh.axis_ranks(axis)
    x_leaves, x_spec = pytree.tree_flatten(xs)
    s_total, t = x_leaves[0].shape[:2]
    if t % n:
        raise ValueError(f"{t} frames do not divide over the {axis} axis of {n}")
    chunk = t // n
    local = [a[:, idx * chunk:(idx + 1) * chunk] for a in x_leaves]
    init_leaves, state_spec = pytree.tree_flatten(init_state)

    recv = [torch.zeros_like(v) for v in init_leaves]
    ys_rows: list = [None] * s_total
    finals: list = [[torch.zeros_like(v) for v in init_leaves] for _ in range(s_total)]
    for p in range(s_total + n - 1):
        s = p - idx  # the sequence this rank scans this round
        if 0 <= s < s_total:
            # stage 0 starts each sequence afresh; the others take the carry
            carry = init_state if idx == 0 else pytree.tree_unflatten(recv, state_spec)
            new_state, ys_rows[s] = scan(
                step_fn, carry, pytree.tree_unflatten([a[s] for a in local], x_spec))
            send = pytree.tree_flatten(new_state)[0]
            if idx == n - 1:
                finals[s] = send
        else:
            send = [torch.zeros_like(v) for v in init_leaves]
        if n > 1:  # hand the carry to the next stage
            ops = []
            if idx < n - 1:
                ops += [dist.P2POp(dist.isend, v.contiguous(), ranks[idx + 1], group, tag=j)
                        for j, v in enumerate(send)]
            if idx > 0:
                recv = [torch.empty_like(v) for v in init_leaves]
                ops += [dist.P2POp(dist.irecv, v, ranks[idx - 1], group, tag=j)
                        for j, v in enumerate(recv)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    ys = _stack(ys_rows)
    final_leaves = [torch.stack(col) for col in zip(*finals)]
    if n > 1:  # the last stage's finals to every rank (JAX: a psum of zeros elsewhere)
        for v in final_leaves:
            dist.broadcast(v, src=ranks[n - 1], group=group)
    return ys, pytree.tree_unflatten(final_leaves, state_spec)
