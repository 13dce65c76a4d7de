"""The traced run: ``torch.profiler`` around the measured window, reduced to
what the per-layer readers take.

- ``kernel_s``: device seconds summed by kernel name over the window;
- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets), so overlap is counted once;
- ``gaps``: the idle intervals between them, each named by the innermost
  host-side span (``record_function``) or operator covering its middle, so
  ``breakdown`` says what the host was doing while the card waited.
"""

from __future__ import annotations

import contextlib
import time

SPAN_PREFIX = "bench."


@contextlib.contextmanager
def span(name: str):
    """A host-side span of the benchmark's own (a ``record_function`` when
    traced; free when the profiler is off)."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Window:
    """Times the window by the host clock and, with ``traced``, records it
    under ``torch.profiler``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.prof = None
        self.start = self.end = 0.0

    def __enter__(self):
        if self.traced:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                             else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.start = time.perf_counter()
        return self

    def stop(self) -> float:
        """Close the window (the caller has synchronised): its seconds."""
        self.end = time.perf_counter()
        return self.end - self.start

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def _raw(prof):
    """(name, device, start_us, end_us) of every event in the trace."""
    try:
        events = prof.profiler.kineto_results.events()
        raw = [(e.name(), e.device_type().name, e.start_ns() / 1e3,
                (e.start_ns() + e.duration_ns()) / 1e3) for e in events]
    except AttributeError:  # an older profiler: the slower event tree
        raw = [(e.name, e.device_type.name, e.time_range.start, e.time_range.end)
               for e in prof.events()]
    # the spans' mirror on the device's timeline is no device activity
    return [r for r in raw if not (r[1] == "CUDA" and r[0].startswith(SPAN_PREFIX))]


def reduce(prof, window_s: float, top: int = 10) -> dict:
    """-> {"kernel_s": {name: s}, "kernel_n": {name: launches}, "busy_s",
    "window_s", "device_ops": [[name, s]], "idle_gaps": [[name, s]]}."""
    import numpy as np

    raw = _raw(prof)
    dev = [(n, a, b) for n, d, a, b in raw if d == "CUDA" and b > a]
    kernel_s, kernel_n = {}, {}
    for name, a, b in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
        kernel_n[name] = kernel_n.get(name, 0) + 1
    merged = []
    for a, b in sorted((a, b) for _, a, b in dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:64]
    host = [(n, a, b) for n, d, a, b in raw if d == "CPU" and b > a]
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host]) if host else np.zeros(0)
    ends = np.array([h[2] for h in host]) if host else np.zeros(0)
    named = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = (names[inside[np.argmin(ends[inside] - starts[inside])]] if inside.size
                 else "no host span")
        named[label] = named.get(label, 0.0) + (b - a) * 1e-6
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return {"kernel_s": kernel_s, "kernel_n": kernel_n, "busy_s": busy, "window_s": window_s,
            "device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in sorted(named.items(),
                                                           key=lambda kv: -kv[1])[:top]]}


def seconds_of(trace: dict, *patterns: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds any of
    ``patterns``."""
    s = n = 0
    for name, v in trace["kernel_s"].items():
        if any(p in name for p in patterns):
            s += v
            n += trace["kernel_n"][name]
    return s, n
