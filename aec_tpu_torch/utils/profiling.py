"""Profiling and tracing utilities (``aec_tpu/utils/profiling.py``):

- :func:`flops` — operation count of one call by
  ``torch.utils.flop_counter.FlopCounterMode`` (the JAX package reads XLA's
  cost analysis);
- :func:`trace` — ``torch.profiler`` over a block, writing a Chrome trace;
- :func:`timed` — median seconds per call, the card synchronized before the
  clock stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import numpy as np
import torch


def flops(fn: Callable, *args, **kwargs) -> dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and return
    its ``flops`` and ``bytes_accessed`` (nan: torch does not count bytes).

    The counter sees the PyTorch operators a call dispatches (matmuls,
    convolutions, attention), not the port's CUDA kernels, which launch
    through ctypes: count on the plain route, CPU tensors (or ``fused=False``
    where a family takes it). Elementwise work is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan")}


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU and (where present) CUDA
    activity; writes ``log_dir/trace.json``, a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn: Callable[..., Any], *args, iters: int = 3, warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)``; each timed call ends in a
    synchronize of the card where one is in use, so the host clock reads the
    device's work, not its enqueue."""
    def run():
        fn(*args)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(warmup):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
