"""Pieces the drivers share: the comparison measure, the seed's sample, the
percentile the tails are read at, and the lower-precision control."""

from __future__ import annotations

import contextlib
import math
import random


def row_gap(out, ref, scale) -> float:
    """The widest gap of any row, as a share of that row's scale:
    ``max_r max_t |out - ref| / scale_r`` (inputs (rows, n); ``scale`` (rows,))."""
    import torch

    d = (out.float() - ref.float()).abs().flatten(1).amax(1)
    return float(torch.max(d / scale.flatten()).item()) if d.numel() else math.nan


def sample(seed: int, population: int, k: int, salt: str) -> list[int]:
    """``k`` indices of ``population`` drawn from the seed (sorted)."""
    rng = random.Random(f"{seed}:{salt}")
    return sorted(rng.sample(range(population), min(k, population)))


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all values (q in (0, 100])."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products and cuDNN on inside the block (the control's precision),
    restored after."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def worst(*values: float) -> float:
    """The largest value, NaN if any is NaN (a NaN must fail the check)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)
