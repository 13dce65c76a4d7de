"""The port's spans and counters (``utils/profiling``): off they record
nothing; on (under ``torch.profiler`` or ``collect()``) they nest by thread,
share a request id under one root, carry the root's counter deltas, stay
within the ring's cap, share kineto's clock, land in ``trace()``'s
``trace.json`` on a ``program`` track, and put no event of their own into
the torch trace. The ``cuda`` tests place K3's launch inside
``serving.launch`` and count ``hop.prepare`` rebuilds on the card.

The file imports neither JAX nor the JAX package, so on a machine with the
card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import contextlib
import importlib
import inspect
import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from aec_tpu_torch.cli.infer import _make_enhancer
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels import hop
from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused
from aec_tpu_torch.models.little_net import little_net_init
from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
from aec_tpu_torch.train import loop
from aec_tpu_torch.utils import profiling
from aec_tpu_torch.utils.weights import load_npz

ROBUST = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "little_net_robust.npz")
SPAN_NAMES = ("two_stage", "serving.", "enhance", "train.")


@contextlib.contextmanager
def _profile():
    """``torch.profiler`` with the card's activity where there is one: a
    process's first session fixes whether kineto records the card at all."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts) as prof:
        yield prof


ON = {"profiler": _profile, "collect": profiling.collect}


def _records(name=None):
    recs = profiling.collected()["records"]
    return [r for r in recs if name is None or r.name == name]


def _one(name):
    (rec,) = _records(name)
    return rec


def _kineto(prof):
    return list(prof.profiler.kineto_results.events())


def _scene(b, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    far = torch.randn(b, n, generator=g)
    mic = 0.5 * torch.roll(far, 3, -1) + 0.01 * torch.randn(b, n, generator=g)
    return far, mic


def test_span_off_records_nothing():
    """Off: one shared no-op context, nothing stored."""
    profiling.reset()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("a") is profiling.span("b") is profiling._OFF
    with profiling.span("a") as s, profiling.span("a.b"):
        pass
    assert s is None
    assert profiling.collected() == {"records": [], "dropped": 0, "summary": {}}


@pytest.mark.parametrize("on", sorted(ON))
def test_spans_nest_share_a_request_and_give_self_time(on):
    """Two roots, each with children: parents, one request id per root, the
    OS thread, durations inside the parent's, self time = duration - the
    children's."""
    with ON[on]():
        profiling.reset()
        for _ in range(2):
            with profiling.span("root"):
                with profiling.span("root.a"):
                    with profiling.span("root.a.x"):
                        torch.ones(64).sum()
                with profiling.span("root.b"):
                    torch.ones(64).sum()
    got = profiling.collected()
    assert got["dropped"] == 0
    recs = got["records"]
    assert [r.name for r in recs] == ["root.a.x", "root.a", "root.b", "root"] * 2  # by end
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["root", "root"]
    assert roots[0].request != roots[1].request
    for r in recs:
        assert r.thread == recs[0].thread == threading.get_native_id()
        if r.parent is not None:
            p = by_id[r.parent]
            assert r.request == p.request == (p.id if p.parent is None else by_id[p.parent].id)
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    s = got["summary"]
    assert {k: v["count"] for k, v in s.items()} == {"root": 2, "root.a": 2, "root.a.x": 2,
                                                      "root.b": 2}
    kids = {rid: sum(r.duration_ns for r in recs if r.parent == rid) for rid in by_id}
    want_self = sum(r.duration_ns - kids[r.id] for r in roots) / 1e6
    assert s["root"]["self_ms"] == pytest.approx(want_self, abs=1e-9)
    assert s["root.a.x"]["self_ms"] == pytest.approx(s["root.a.x"]["total_ms"], abs=1e-9)
    assert 0 < s["root"]["self_ms"] < s["root"]["total_ms"]
    assert s["root"]["median_ms"] <= s["root"]["p95_ms"]


def test_root_spans_carry_counter_deltas(monkeypatch):
    """A root records every counter that changed over it, by how much; a
    child records none."""
    with profiling.collect():
        with profiling.span("root"):
            with profiling.span("root.child"):
                monkeypatch.setattr(serving_step_fused, "launches",
                                    serving_step_fused.launches + 2)
                monkeypatch.setattr(serving_step_fused, "steps",
                                    dict(serving_step_fused.steps,
                                         fft=serving_step_fused.steps["fft"] + 2))
                monkeypatch.setattr(hop.prepare, "builds", hop.prepare.builds + 1)
        with profiling.span("quiet"):
            pass
    assert _one("root").counters == {"serving.serving_step_fused.launches": 2,
                                     "serving.serving_step_fused.steps.fft": 2,
                                     "hop.prepare.builds": 1}
    assert _one("root.child").counters is None
    assert _one("quiet").counters == {}
    assert profiling.collected()["summary"]["root"]["counters"]["hop.prepare.builds"] == 1


def test_counters_read_every_kernel_wrapper():
    """counters() reads each wrapper of COUNTED, and COUNTED names every
    function of ``aec_tpu_torch.kernels`` that carries a launch counter."""
    flat = profiling.counters()
    assert flat["hop.prepare.builds"] == hop.prepare.builds
    assert flat["serving.serving_step_fused.steps.dense"] == serving_step_fused.steps["dense"]
    kernels = os.path.dirname(hop.__file__)
    found = set()
    for fname in os.listdir(kernels):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        mod = importlib.import_module(f"aec_tpu_torch.kernels.{fname[:-3]}")
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ == mod.__name__ and any(
                    hasattr(fn, a) for a in ("launches", "wide_launches", "steps", "builds")):
                found.add(f"{fname[:-3]}.{name}")
    listed = {f"{m}.{f}" for m, fns in profiling.COUNTED.items() for f in fns}
    assert found == listed
    for name in listed:
        assert any(k.startswith(name + ".") for k in flat), name


def test_ring_keeps_its_cap_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "RING_CAP", 3)
    with profiling.collect():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    got = profiling.collected()
    assert [r.name for r in got["records"]] == ["s2", "s3", "s4"]
    assert got["dropped"] == 2
    profiling.reset()
    assert profiling.collected()["dropped"] == 0


def test_span_shares_kinetos_clock():
    """A ``record_function`` entered inside a span lies inside it in the
    kineto trace: the spans' stamps are kineto's host clock."""
    with _profile() as prof:
        profiling.reset()
        with profiling.span("outer"):
            with record_function("probe"):
                torch.ones(256).cumsum(0)
    (probe,) = [e for e in _kineto(prof) if e.name() == "probe"]
    outer = _one("outer")
    assert outer.start_ns <= probe.start_ns() <= probe.end_ns() <= outer.end_ns
    # the profiler's own enter and exit cost lie between them, no more
    assert probe.start_ns() - outer.start_ns < 50e6


def test_trace_writes_spans_on_a_program_track(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("outer"):
            with profiling.span("outer.inner"):
                torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    prog = {e["name"]: e for e in doc["traceEvents"] if e.get("pid") == "program"
            and e["ph"] == "X"}
    assert set(prog) == {"outer", "outer.inner"}
    for name in prog:
        rec = _one(name)
        assert prog[name]["ts"] == pytest.approx((rec.start_ns - base) / 1e3, abs=1e-3)
        assert prog[name]["dur"] == pytest.approx(rec.duration_ns / 1e3, abs=1e-3)
        assert prog[name]["tid"] == rec.thread
    assert prog["outer.inner"]["args"]["parent"] == prog["outer"]["args"]["id"]
    # on the same time base as kineto's own host events
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::ones"]
    assert ops and prog["outer"]["ts"] <= ops[0]["ts"] <= prog["outer"]["ts"] + \
        prog["outer"]["dur"]
    assert any(e["ph"] == "M" and e.get("pid") == "program" for e in doc["traceEvents"])


def test_profiled_two_stage_adds_no_event_to_the_torch_trace():
    """The plain route under ``torch.profiler``: the spans are recorded,
    stage 1 and stage 2 under the root, and no event of the torch trace is
    named like a program span."""
    net = little_net_init(generator=torch.Generator().manual_seed(0), device="cpu")
    far, mic = _scene(2, 16 * 256)
    with _profile() as prof:
        profiling.reset()
        two_stage_cancel(net, far, mic, erb_filterbank(), stage1="kalman")
    names = {e.name() for e in _kineto(prof)}
    assert not [n for n in names if n.startswith(SPAN_NAMES)]
    root, s1, s2 = _one("two_stage"), _one("two_stage.stage1"), _one("two_stage.stage2")
    assert root.parent is None and s1.parent == s2.parent == root.id
    assert s1.end_ns <= s2.start_ns


def test_enhancer_and_serving_step_spans():
    """``enhance`` with its two children on the CPU; ``serving.step`` alone
    on the CPU (the plain route has no prepared launch)."""
    enhance, _ = _make_enhancer("little_net", ROBUST, "kalman", StftConfig(), device="cpu")
    far, mic = _scene(1, 8 * 256, 1)
    net = load_npz(ROBUST, device="cpu")
    state = serving_init(2, device="cpu")
    with profiling.collect():
        enhance(far, mic)
        serving_step_fused(net, state, far[:, :512].repeat(2, 1), mic[:, :512].repeat(2, 1),
                           torch.as_tensor(erb_filterbank()))
    root = _one("enhance")
    assert _one("enhance.stage1").parent == _one("enhance.net").parent == root.id
    assert _one("serving.step").parent is None
    assert not _records("serving.launch")


@pytest.mark.parametrize("builder", ["make_train_step", "make_stateful_train_step"])
def test_train_step_spans(builder):
    """``train.step`` over forward, backward and the update, in that order,
    each once per step."""
    net = torch.nn.Linear(4, 1)
    opt = loop.Optimizer(TrainConfig(lr=1e-3), 10, net)
    x = torch.randn(8, 4)
    if builder == "make_train_step":
        def loss(n, mic, ref, near, erb, cfg, sqrt_eps):
            return ((n(mic) - ref) ** 2).mean(), {}

        step, args = loop.make_train_step(loss, opt), (x, x[:, :1], None, None)
    else:
        def loss(p, state, mic, ref):
            return ((p(mic) - ref) ** 2).mean(), {"state": {}}

        step, args = loop.make_stateful_train_step(loss, opt), ({}, x, x[:, :1])
    with profiling.collect():
        step(*args)
        step(*args)
    roots = _records("train.step")
    assert len(roots) == 2
    for root in roots:
        kids = [r for r in _records() if r.parent == root.id]
        assert [k.name for k in kids] == ["train.forward", "train.backward", "train.update"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


# ----------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _serving_call(dev, streams=64):
    net = load_npz(ROBUST, device=dev)
    erb = torch.as_tensor(erb_filterbank(), device=dev)
    state = serving_init(streams, device=dev)
    far, mic = (t.to(dev) for t in _scene(streams, 256, 2))

    def call():
        serving_step_fused(net, state, far, mic, erb)

    return net, call


@pytest.mark.cuda
def test_k3_launch_lies_inside_serving_launch(cuda):
    """One traced call: the runtime call that launched K3 (by the kernel's
    correlation id) lies inside ``serving.launch``, on kineto's clock."""
    _, call = _serving_call(cuda)
    call()
    torch.cuda.synchronize()
    with _profile() as prof:
        profiling.reset()
        call()
        torch.cuda.synchronize()
    events = _kineto(prof)
    seen = [(e.device_type().name, e.name()[:60], e.correlation_id(), e.start_ns(), e.end_ns())
            for e in events]
    kernels = [e for e in events if e.device_type().name == "CUDA" and "serving" in e.name()]
    assert len(kernels) == 1, seen
    corr = kernels[0].correlation_id()
    runtime = [e for e in events if e.device_type().name == "CPU"
               and e.correlation_id() == corr and "aunch" in e.name()]
    launch = _one("serving.launch")
    where = (launch.start_ns, launch.end_ns, seen)
    assert runtime, where
    assert launch.parent == _one("serving.step").id
    for e in runtime:
        assert launch.start_ns <= e.start_ns() <= e.end_ns() <= launch.end_ns, where
    assert not [e for e in events if e.name().startswith(SPAN_NAMES)]


@pytest.mark.cuda
def test_prepare_builds_count_rebuilds(cuda):
    """``hop.prepare.builds`` stays put on a repeated call and rises by one
    after a ``copy_`` into a weight (its version moves)."""
    net, call = _serving_call(cuda)
    call()
    before = hop.prepare.builds
    call()
    call()
    assert hop.prepare.builds == before
    with torch.no_grad():
        net.linear1.weight.copy_(net.linear1.weight * 1.0)
    with profiling.collect():
        call()
        call()
    assert hop.prepare.builds == before + 1
    assert [r.counters.get("hop.prepare.builds", 0) for r in _records("serving.step")] == [1, 0]
