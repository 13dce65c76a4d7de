"""Reductions over the global batch of a data-parallel step.

JAX has no such module: under GSPMD one jitted step sees the whole batch,
so every ``jnp.mean`` in a loss, a pseudo-norm or a BatchNorm is already a
mean over all ranks' rows. In the port each rank sees its own rows, so the
functions that reduce over the batch ask this module, which reduces over
the data axis of the mesh that a step has put in force with
:func:`global_batch`. Outside that scope :func:`data_group` is None and each
function here is the local reduction the code had before, op for op, so a
call without a mesh gives the same bits as before.

The rule that keeps the numbers JAX's: each rank's loss is its share of
the global loss L, the shares summing to L exactly. A batch sum
(LittleNet) is each rank's own sum; a mean is each rank's sum over the
global count (:func:`mean_share`); a statistic inside the forward (the
pseudo-norm, BatchNorm) is the global value itself (:func:`mean`), reduced
through :func:`all_sum`, whose backward sums the cotangents over the ranks.
The step then sums the gradients over the ranks (not DDP's mean), so
Adam and clipping see the global gradient.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_GROUP: contextvars.ContextVar = contextvars.ContextVar("aec_data_group", default=None)


@contextlib.contextmanager
def global_batch(mesh):
    """Reduce over ``mesh``'s data axis inside the block (one step); no-op
    for ``mesh`` None or a mesh without process groups."""
    group = None if mesh is None else mesh.group("data")
    token = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(token)


def data_group():
    """The data axis's process group of the step in force, or None."""
    return _GROUP.get()


def collectives() -> None:
    """Count one collective over the data group (``collectives.count``, read
    by ``utils/profiling.counters`` as ``global_batch.collectives``): each
    :func:`all_sum` forward and backward and each :func:`sum_gradients`."""
    collectives.count += 1


collectives.count = 0


class _AllSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the cotangents over
    them (each rank's cotangent is its share's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        collectives()
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        collectives()
        return g, None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the data group in force; ``x``
    itself without one."""
    group = data_group()
    return x if group is None else _AllSum.apply(x, group)


def count(n_local: int) -> int:
    """The global number of elements a reduction covers: ``n_local`` times
    the ranks of the data group in force (``n_local`` without one). Every
    rank holds the same number of rows (``mesh.globalize_batch``), so the
    count needs no collective."""
    group = data_group()
    return n_local if group is None else n_local * dist.get_world_size(group)


def mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The mean over the global batch (``torch.mean(x[, dim])`` on the
    ranks' rows taken together), the same on every rank: each rank's mean
    weighted by its share of the global count, summed (:func:`all_sum`)."""
    m = torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    if data_group() is None:
        return m
    n = x.numel() // max(m.numel(), 1)
    return all_sum(m * (n / count(n)))


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's term of a loss that is a mean over the global batch:
    its sum over the global count (``torch.mean(x)`` without a group); the
    terms of all ranks sum to the global mean."""
    m = torch.mean(x)
    if data_group() is None:
        return m
    return m * (x.numel() / count(x.numel()))


def sum_gradients(params: list[torch.nn.Parameter], loss: torch.Tensor, group) -> torch.Tensor:
    """After ``backward()``: replace each parameter's gradient by its sum
    over ``group`` and return the summed loss, in one all-reduce of a flat
    bucket (the loss rides at its end). A parameter the loss does not
    reach takes a zero gradient, as the optimizer's update gives it."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=group)
    collectives()
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).clone()
        offset += n
    return flat[-1].to(loss.dtype)
