"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, the harness driven on the CPU (the card's look
skipped) with the program's entry replaced by a broken one.

One card, so "the exchange between chips left out" is no fault these cells
can have."""

from __future__ import annotations

import pytest

from aec_bench.tests.helpers import run_cell, tiny_root


def altered_bulk(fn):
    def call(*a, **k):
        out = dict(fn(*a, **k))
        out["wav"] = out["wav"] * 1.01  # an answer altered where it is produced
        return out
    return call


def half_bulk(fn):
    def call(net, far, mic, *a, **k):
        half = far.shape[0] // 2 or 1
        out = fn(net, far[:half], mic[:half], *a, **k)  # half of the batch left out
        return {key: v.repeat((far.shape[0] + half - 1) // half, *[1] * (v.ndim - 1))
                [:far.shape[0]] for key, v in out.items()}
    return call


def unchanged_serve(fn):
    def call(net, state, *a, **k):
        scratch = {key: v.clone() for key, v in state.items()}
        _, out = fn(net, scratch, *a, **k)
        return state, out  # a step that returns its state unchanged
    return call


def altered_serve(fn):
    def call(*a, **k):
        state, out = fn(*a, **k)
        return state, out + 1e-3 * out.abs().amax()
    return call


def half_serve(fn):
    def call(net, state, far, mic, *a, **k):
        h = far.shape[0] // 2
        part = {key: v[:h].clone() for key, v in state.items()}
        _, out = fn(net, part, far[:h].contiguous(), mic[:h].contiguous(), *a, **k)
        for key, v in part.items():
            state[key][:h] = v
        full = far.new_zeros(far.shape)
        full[:h] = out
        return state, full
    return call


def unchanged_train(make):
    def build(loss_fn, optimizer, mesh=None):
        step = make(loss_fn, optimizer, mesh)

        def call(state, *batch):
            saved = [p.detach().clone() for p in optimizer.net.parameters()]
            new_state, loss = step(state, *batch)
            for p, s in zip(optimizer.net.parameters(), saved):
                p.data.copy_(s)  # the update never lands
            return state, loss
        return call
    return build


def half_train(make):
    def build(loss_fn, optimizer, mesh=None):
        step = make(loss_fn, optimizer, mesh)
        return lambda state, *batch: step(state, *[b[: b.shape[0] // 2] for b in batch])
    return build


def altered_infer(fn):
    def build(*a, **k):
        enhance, params = fn(*a, **k)
        return (lambda far, mic: enhance(far, mic) * 1.01), params
    return build


FAULTS = [
    ("littlenet_kalman.bulk", "aec_tpu_torch.pipeline.two_stage", "two_stage_cancel", altered_bulk),
    ("littlenet_kalman.bulk", "aec_tpu_torch.pipeline.two_stage", "two_stage_cancel", half_bulk),
    ("littlenet_kalman.serve", "aec_tpu_torch.kernels.serving", "serving_step_fused",
     unchanged_serve),
    ("littlenet_kalman.serve", "aec_tpu_torch.kernels.serving", "serving_step_fused",
     altered_serve),
    ("littlenet_kalman.serve", "aec_tpu_torch.kernels.serving", "serving_step_fused", half_serve),
    ("dccrn.train", "aec_tpu_torch.train.loop", "make_stateful_train_step", unchanged_train),
    ("dccrn.train", "aec_tpu_torch.train.loop", "make_stateful_train_step", half_train),
    ("dccrn.infer", "aec_tpu_torch.cli.infer", "_make_enhancer", altered_infer),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, _, f in FAULTS])
def test_fault_is_not_correct(root, monkeypatch, cell, module, name, fault):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    code, line, err = run_cell(root, cell, seconds=0.4)
    assert code == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["littlenet_kalman.bulk", "littlenet_kalman.serve",
                                  "dccrn.train", "dccrn.infer"])
def test_sound_run_is_correct(root, cell):
    code, line, err = run_cell(root, cell, seconds=0.4)
    assert code == 0, err
    assert line["correct"] is True, line["checks"]
