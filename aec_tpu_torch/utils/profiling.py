"""Profiling and tracing utilities (``aec_tpu/utils/profiling.py``):

- :func:`flops` — operation count of one call by
  ``torch.utils.flop_counter.FlopCounterMode`` (the JAX package reads XLA's
  cost analysis);
- :func:`span` — the program's own spans at its layer boundaries: the
  two-stage pipeline (``two_stage``, ``two_stage.stage1``,
  ``two_stage.stage2``), K3's serving step (``serving.step``,
  ``serving.prepare``, ``serving.launch``), the inference enhancer
  (``enhance``, ``enhance.stage1``, ``enhance.net``), the train steps
  (``train.step``, ``train.forward``, ``train.backward``, ``train.update``,
  ``train.allreduce``: the gradient sum of a data-parallel step) and
  FullSubNet's bands (``fsn.fb``, ``fsn.sb``, ``fsn.head``);
- :func:`counters` — every kernel wrapper's ``launches``,
  ``wide_launches``, ``steps[...]`` and ``hop.prepare.builds``, the frames
  run on plain recurrence loops on the card (``lstm.plain_steps``) and the
  data-parallel collectives (``global_batch.collectives``) in one flat
  dict;
- :func:`collect`, :func:`collected`, :func:`reset` — turn the spans on
  without the profiler, read what they recorded, clear it;
- :func:`trace` — ``torch.profiler`` over a block, writing a Chrome trace
  with the spans on a ``program`` track beside the device timeline.

The spans are on while a ``torch.profiler`` records or inside
:func:`collect`; otherwise :func:`span` reads a flag and returns one shared
no-op context. They put no event into the torch trace (a
``record_function`` would leave a mirror on the device's timeline, which a
reading of the trace takes for device activity): each is kept in this
module's memory, a ring of at most :data:`RING_CAP` records, stamped with
``time.time_ns()``, the clock kineto stamps its host events with.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import itertools
import json
import math
import os
import statistics
import threading
import time
from typing import Callable, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

RING_CAP = 1 << 20  # records kept; the oldest are dropped, and counted, past it

# the kernel wrappers whose counters :func:`counters` reads, by module of
# ``aec_tpu_torch.kernels``
COUNTED = {
    "gru": ("gru_recurrence", "gru_backward"),
    "fullsubnet": ("joint_recurrence",),
    "hop": ("prepare",),
    "kalman": ("kalman_cancel_fused_batched", "kalman_cancel_fused",
               "kalman_filter_fused_batched"),
    "lstm": ("grouped_lstm_recurrence",),
    "lstm_bwd": ("lstm_backward",),
    "lstm_int8": ("lstm_int8_recurrence",),
    "lstm_rows": ("rows_recurrence", "rows_backward"),
    "nlms": ("nlms_cancel_fused_batched", "nlms_cancel_fused"),
    "serving": ("serving_step_fused",),
    "stage2": ("little_net_apply_fused",),
    "two_stage": ("two_stage_fused",),
}
_SCALARS = ("launches", "wide_launches", "builds")


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


_reads: list | None = None  # (wrapper, [(attribute, key)], steps' key prefix or None)


def counters() -> dict[str, int]:
    """Every counted kernel wrapper's counters, flat:
    ``{"<module>.<function>.<counter>": n}`` with ``steps``' keys one level
    further (``"serving.serving_step_fused.steps.fft"``). The counters stay
    the wrappers' attributes; this reads them. The first call imports the
    kernel modules (no kernel is built)."""
    global _reads
    if _reads is None:
        _reads = []
        for mod, fns in COUNTED.items():
            module = importlib.import_module(f"aec_tpu_torch.kernels.{mod}")
            for name in fns:
                fn = getattr(module, name)
                _reads.append((fn, [(a, f"{mod}.{name}.{a}") for a in _SCALARS if hasattr(fn, a)],
                               f"{mod}.{name}.steps." if hasattr(fn, "steps") else None))
    from aec_tpu_torch.ops.lstm import count_plain
    from aec_tpu_torch.parallel.global_batch import collectives

    out = {"lstm.plain_steps": count_plain.steps, "global_batch.collectives": collectives.count}
    for fn, scalars, steps in _reads:
        for attr, key in scalars:
            out[key] = getattr(fn, attr)
        if steps is not None:
            for key, value in fn.steps.items():
                out[steps + key] = value
    return out


class Record(NamedTuple):
    """One finished span: ``name``, ``start_ns`` and ``end_ns`` (kineto's
    clock), ``id``, ``parent`` (the enclosing span's id, None for a root),
    ``thread`` (the OS thread id, as the trace's ``tid``), ``request`` (the
    root's id, shared by its children) and, on a root, ``counters``: each
    counter of :func:`counters` that changed over the span, by how much
    (None on a child)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    thread: int
    request: int
    counters: dict | None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Span:
    """An open span: the context :func:`span` returns while tracing is on."""

    __slots__ = ("name", "start_ns", "id", "parent", "request", "before", "lend", "lent")

    def __init__(self, name: str, lend: bool = False):
        self.name, self.lend = name, lend

    def __enter__(self):
        global _lent
        stack = _stack()
        parent = stack[-1] if stack else _lent
        self.id = next(_ids)
        if parent is None:
            self.parent, self.request, self.before = None, self.id, counters()
        else:
            self.parent, self.request, self.before = parent.id, parent.request, None
        stack.append(self)
        if self.lend:
            self.lent, _lent = _lent, self
        self.start_ns = time.time_ns()

    def __exit__(self, *exc):
        global _lent
        end = time.time_ns()
        _stack().pop()
        if self.lend:
            _lent = self.lent
        before = self.before
        if before is not None:
            before = tuple((k, v - before.get(k, 0)) for k, v in counters().items()
                           if v != before.get(k, 0))
        # plain tuples, which the garbage collector stops tracking (a Record,
        # a subclass, or a dict it would walk at every collection)
        _store.add((self.name, self.start_ns, end, self.id, self.parent, _local.thread,
                    self.request, before))
        return False


class _Off:
    """The shared context :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Store:
    """The ring of finished spans and the count of those it dropped."""

    def __init__(self, cap: int):
        self.ring = collections.deque(maxlen=cap)
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, record: tuple) -> None:
        with self.lock:
            if len(self.ring) == self.ring.maxlen:
                self.dropped += 1
            self.ring.append(record)


_store = _Store(RING_CAP)
_ids = itertools.count(1)
_local = threading.local()
_collecting = 0  # depth of :func:`collect` blocks
_lent = None  # the span lent to spans that open on a thread with none open
_collect_lock = threading.Lock()


def _stack() -> list:
    """This thread's open spans (and its OS thread id beside them)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.thread = [], threading.get_native_id()
        return _local.stack


def span(name: str, lend: bool = False):
    """A context manager around one layer's work: records a :class:`Record`
    while a ``torch.profiler`` records or inside :func:`collect`, and is a
    shared no-op otherwise. Spans nest by thread; a root span also records
    the counters' change (:func:`counters`). With ``lend`` the span is also
    the parent of spans opened, while it is open, on threads that have none
    open: autograd runs a CUDA backward on its own thread, so the spans of
    ``loss.backward()``'s Functions nest under the caller's span."""
    if _collecting or _autograd_profiler._is_profiler_enabled:
        return _Span(name, lend)
    return _OFF


def reset() -> None:
    """Forget every recorded span and the drop count (a ring of
    :data:`RING_CAP` records from here on)."""
    global _store
    _store = _Store(RING_CAP)


@contextlib.contextmanager
def collect():
    """Spans on inside the block without the profiler; the outermost block
    starts from an empty store (:func:`reset`). Read them with
    :func:`collected`."""
    global _collecting
    with _collect_lock:
        if not _collecting:
            reset()
        _collecting += 1
    try:
        yield
    finally:
        with _collect_lock:
            _collecting -= 1


def _p95(sorted_values: list) -> float:
    """The nearest-rank 95th percentile of sorted values."""
    return sorted_values[max(0, math.ceil(0.95 * len(sorted_values)) - 1)]


def collected() -> dict:
    """-> ``{"records": [Record], "dropped": n, "summary": {name: {"count",
    "median_ms", "p95_ms", "total_ms", "self_ms", "counters"}}}``: the
    recorded spans in the order they ended, how many the ring dropped, and
    by name the duration's median and p95, its total, the self time (the
    durations less the part their children cover) and, for roots, the
    counters' change summed."""
    with _store.lock:
        records = [Record(*r[:7], None if r[7] is None else dict(r[7])) for r in _store.ring]
        dropped = _store.dropped
    covered = collections.Counter()
    for r in records:
        if r.parent is not None:
            covered[r.parent] += r.duration_ns
    groups = collections.defaultdict(list)
    for r in records:
        groups[r.name].append(r)
    summary = {}
    for name, rs in groups.items():
        ms = sorted(r.duration_ns / 1e6 for r in rs)
        summed = collections.Counter()
        for r in rs:
            summed.update(r.counters or {})
        summary[name] = {
            "count": len(rs), "median_ms": statistics.median(ms), "p95_ms": _p95(ms),
            "total_ms": math.fsum(ms),
            "self_ms": sum(r.duration_ns - covered[r.id] for r in rs) / 1e6,
            "counters": dict(summed),
        }
    return {"records": records, "dropped": dropped, "summary": summary}


def _program_events(records: list, base_ns: int) -> list[dict]:
    """Chrome-trace events of the spans on a ``program`` track, timed from
    ``base_ns`` in µs as kineto writes its own."""
    events = [{"ph": "M", "name": "process_name", "pid": "program", "tid": 0,
               "args": {"name": "program"}}]
    for r in records:
        args = {"id": r.id, "parent": r.parent, "request": r.request}
        if r.counters:
            args["counters"] = r.counters
        events.append({"ph": "X", "cat": "program", "name": r.name, "pid": "program",
                       "tid": r.thread, "ts": (r.start_ns - base_ns) / 1e3,
                       "dur": r.duration_ns / 1e3, "args": args})
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU and (where present) CUDA
    activity; writes ``log_dir/trace.json``, a Chrome trace, with the
    program's spans of the block (:func:`span`; the store is reset on entry)
    on a ``program`` track, on the trace's own ``baseTimeNanoseconds``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_program_events(collected()["records"],
                                              int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)
