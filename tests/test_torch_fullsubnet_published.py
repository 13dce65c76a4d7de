"""FullSubNet at its published structure (``FullSubNetConfig.published()``)
against the benchmark's plain reference, ``aec_bench/reference/fullsubnet.py``
(plain torch, independent of the port), on seeded random weights.

The structure is the published one at small widths (F = 33 from an STFT of
64 / 32, H = 16 and 12, two layers a band, +-3 bins, look-ahead 2, both
Laplace norms, drop band of 2), so the CPU runs it in seconds: the masks at
inference and under drop band, the loss and every leaf's gradient, the
pieces (norm, unfolding, drop band's rows), the layer Function's
gradients on both routes, the adapter, the spans and the plain-loop
counter. The published widths' parameter count is checked whole.

The file imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import socket
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from aec_bench.reference import fullsubnet as ref
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp import stft as stft_mod
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels.lstm_rows import FEW_ROWS, lstm_layer
from aec_tpu_torch.models import fullsubnet as fsn
from aec_tpu_torch.models.tree_net import functional_params
from aec_tpu_torch.ops.lstm import lstm_init, lstm_scan
from aec_tpu_torch.parallel.mesh import make_mesh
from aec_tpu_torch.train import loop
from aec_tpu_torch.train.generic import make_adapter
from aec_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
BENCH_CFG = json.loads((REPO / "aec_bench" / "configs" / "fullsubnet.json").read_text())
SMALL = dataclasses.replace(fsn.FullSubNetConfig.published(),
                            stft=StftConfig(64, 32, 64), fb_hidden=16, sb_hidden=12,
                            neighborhood=3)
SMALL_REF = {"stft": {"win": 64, "hop": 32},
             "net": dict(BENCH_CFG["net"], num_freqs=33, fb_model_hidden_size=16,
                         sb_model_hidden_size=12, sb_num_neighbors=3)}
B, N = 4, 32 * 24  # 25 frames, 27 with the look-ahead
# Two float32 evaluations of one function that sum the projections, biases
# and products in other orders (the port hoists x W_ih^T + b_ih + b_hh into
# one addmm, the reference adds after the product): a mask in [0, 1] is
# held to 2e-6 (about 16 float32 ulps at 1), the loss to 1e-5 relative,
# each gradient leaf to 1e-4 of its largest element (a sum over 100 rows x
# 27 frames of terms of both signs).
MASK_ATOL, LOSS_RTOL, GRAD_RTOL = 2e-6, 1e-5, 1e-4


def _weights(seed=3):
    return ref.make_weights(SMALL_REF, seed, "cpu")[0]


def _batch(seed=5):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, N, generator=g) * s for s in (0.5, 0.5, 0.3, 0.2))


def _count(tree):
    return sum(t.numel() for _, t in ref.leaves(tree))


def _with_grad(tree):
    return ref.rebuild(tree, {k: t.detach().clone().requires_grad_(True)
                              for k, t in ref.leaves(tree)})


def test_published_parameter_count():
    """5,685,251 parameters at the published widths, in the port's init and
    the reference's draw; the configuration file says the same."""
    cfg = fsn.FullSubNetConfig.published()
    assert cfg.layered and cfg.n_freqs == 257 and cfg.sb_input == 63 and cfg.fb_input == 257
    assert _count(fsn.fullsubnet_init(cfg, device="cpu")) == 5_685_251
    assert _count(ref.make_weights(BENCH_CFG, 1, "cpu")[0]) == 5_685_251
    assert BENCH_CFG["params"] == 5_685_251 and BENCH_CFG["reduced"] == []


def test_default_config_is_untouched():
    """The small default keeps its one-layer tree and the joint form K11 takes."""
    cfg = fsn.FullSubNetConfig()
    assert not cfg.layered and cfg.fb_input == 2 * 161
    tree = fsn.fullsubnet_init(cfg, device="cpu")
    assert isinstance(tree["fb_lstm"], dict) and isinstance(tree["sb_lstm"], dict)


@pytest.mark.parametrize("train", [False, True])
def test_masks_against_reference(train):
    """Masks and the sub band's rows (every bin at inference, drop band's in
    training) against the reference's; look-ahead frames dropped alike."""
    p = _weights()
    mic, far, _, _ = _batch()
    mag = stft_mod.magnitude(stft_mod.stft(mic, SMALL.stft))
    far_mag = stft_mod.magnitude(stft_mod.stft(far, SMALL.stft))
    near, echo, s, f = fsn._layered_masks(p, mag, far_mag, SMALL, train)
    r_near, r_echo, r_s, r_f = ref.masks(p, SMALL_REF, mic, far, train)
    assert torch.equal(s, r_s) and torch.equal(f, r_f)
    rows = (B // 2) * 16 * 2 if train else B * 33
    assert near.shape == (rows, mag.shape[1]) == r_near.shape
    torch.testing.assert_close(near, r_near, atol=MASK_ATOL, rtol=0)
    torch.testing.assert_close(echo, r_echo, atol=MASK_ATOL, rtol=0)


def test_apply_gives_every_bin():
    p = _weights()
    mic, far, _, _ = _batch()
    out = fsn.fullsubnet_apply(p, mic, far, SMALL)
    r_near, _, _, _ = ref.masks(p, SMALL_REF, mic, far, False)
    t = out["mask_near"].shape[1]
    assert out["mask_near"].shape == (B, t, 33) and out["wav"].shape == (B, N)
    torch.testing.assert_close(out["mask_near"], r_near.reshape(B, 33, t).transpose(1, 2),
                               atol=MASK_ATOL, rtol=0)


@pytest.mark.parametrize("block", [0, 24])
def test_loss_and_every_gradient_against_reference(block):
    """The training loss (drop band, both terms over the kept pairs) and
    every leaf's gradient against the reference's, whose sub band runs
    whole or in blocks of 24 rows."""
    p = _weights()
    batch = _batch()
    mine = _with_grad(p)
    loss, _ = fsn.fullsubnet_loss(mine, *batch, SMALL, train=True)
    leaves = dict(ref.leaves(mine))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want, want_g = ref.loss_and_grads(_with_grad(p), SMALL_REF, batch, block)
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=LOSS_RTOL, atol=0)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        scale = float(want_g[k].abs().max())
        assert scale > 0, k
        assert float((g - want_g[k]).abs().max()) <= GRAD_RTOL * scale, k


def test_reference_blocks_sum_to_the_whole():
    p = _weights()
    batch = _batch()
    whole = ref.loss(_with_grad(p), SMALL_REF, batch)
    value, _ = ref.loss_and_grads(_with_grad(p), SMALL_REF, batch, 7)
    torch.testing.assert_close(value.detach(), whole.detach(), rtol=1e-6, atol=0)


def test_pieces_against_reference():
    """The Laplace norm, the reflect unfolding and drop band's rows."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(3, 7, 10, generator=g)
    torch.testing.assert_close(fsn.laplace_norm(x), ref.norm(x, BENCH_CFG["net"]["norm_eps"]),
                               rtol=0, atol=0)
    assert fsn.LAPLACE_EPS == BENCH_CFG["net"]["norm_eps"]
    assert torch.equal(fsn._unfold_bins(x, 3), ref.unfold(x, 3))
    for b, f, groups in ((16, 257, 2), (4, 33, 2), (5, 10, 3), (3, 8, 1)):
        s, fb = fsn.drop_band_rows(b, f, groups)
        r_s, r_f = ref.rows_of(b, f, groups, "cpu")
        assert torch.equal(s, r_s) and torch.equal(fb, r_f)
        if groups > 1:
            assert torch.equal(s % groups, fb % groups) and int(fb.max()) < f - f % groups
    assert len(fsn.drop_band_rows(16, 257, 2)[0]) == 2048


@pytest.mark.parametrize("rows", [FEW_ROWS - 24, FEW_ROWS + 8])
def test_layer_function_against_autograd(rows):
    """``lstm_layer`` (its Function over the plain versions on the CPU, on
    either route) against autograd through the plain ``lstm_scan``: the
    output and the gradients of x and of the four weights."""
    g = torch.Generator().manual_seed(rows)
    p = {k: v.requires_grad_(True) for k, v in lstm_init(5, 6, generator=g, device="cpu").items()}
    x = torch.randn(rows, 9, 5, generator=g, requires_grad=True)
    w = torch.randn(rows, 9, 6, generator=g)
    ys = lstm_layer(p, x)
    want = lstm_scan(p, x)[0]
    torch.testing.assert_close(ys, want, rtol=1e-5, atol=1e-6)
    ins = [x, *p.values()]
    got = torch.autograd.grad((ys * w).sum(), ins)
    exp = torch.autograd.grad((want * w).sum(), ins)
    for a, e in zip(got, exp):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


def test_adapter_takes_the_published_configuration():
    """``make_adapter("fullsubnet", model_cfg=...)`` trains the layered form
    through ``make_stateful_train_step``; ``train`` turns drop band on."""
    adapter = make_adapter("fullsubnet", model_cfg=SMALL)
    net = adapter.module(_weights(), {})
    batch = _batch()
    eval_loss, _ = adapter.loss(functional_params(net), {}, *batch, False)
    train_loss, _ = adapter.loss(functional_params(net), {}, *batch, True)
    want = ref.loss(_weights(), SMALL_REF, batch, train=False)
    torch.testing.assert_close(eval_loss.detach(), want, rtol=LOSS_RTOL, atol=0)
    assert float(train_loss.detach()) != float(eval_loss.detach())
    step = _step(adapter, net)
    before = net.params()["sb_lstm"][1]["w_hh"].detach().clone()
    _, value = step({}, *batch)
    assert torch.isfinite(value) and not torch.equal(before, net.params()["sb_lstm"][1]["w_hh"])


def _step(adapter, net, mesh=None):
    opt = loop.Optimizer(TrainConfig(lr=1e-3, batch_size=B), 10, net)

    def step_loss(p, s, *batch):
        value, state = adapter.loss(p, s, *batch, True)
        return value, {"state": state}

    return loop.make_stateful_train_step(step_loss, opt, mesh)


def test_fsn_spans_nest_under_the_train_step():
    """``fsn.fb``, ``fsn.sb`` and ``fsn.head`` inside ``train.forward``;
    the bands' backwards (the layer Function's) inside ``train.backward``."""
    adapter = make_adapter("fullsubnet", model_cfg=SMALL)
    step = _step(adapter, adapter.module(_weights(), {}))
    with profiling.collect():
        step({}, *_batch())
    recs = profiling.collected()["records"]
    by_id = {r.id: r for r in recs}
    parents = {}
    for r in recs:
        if r.name.startswith("fsn."):
            parents.setdefault(r.name, set()).add(by_id[r.parent].name)
    assert parents == {"fsn.fb": {"train.forward", "train.backward"},
                       "fsn.sb": {"train.forward", "train.backward"},
                       "fsn.head": {"train.forward"}}
    assert not [r for r in recs if r.name == "train.allreduce"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_allreduce_span_only_with_a_data_group():
    """``train.allreduce`` around the gradient sum, and the collectives
    counted, only where a mesh with a data group is in force (one gloo
    rank here)."""
    adapter = make_adapter("fullsubnet", model_cfg=SMALL)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        for m, want in ((None, 0), (mesh, 1)):
            step = _step(adapter, adapter.module(_weights(), {}), m)
            with profiling.collect():
                with profiling.span("root"):
                    step({}, *_batch())
            recs = profiling.collected()["records"]
            spans = [r for r in recs if r.name == "train.allreduce"]
            assert len(spans) == want
            root = [r for r in recs if r.name == "root"][0]
            assert root.counters.get("global_batch.collectives", 0) == want
            if want:
                assert {r.name for r in recs if r.id == spans[0].parent} == {"train.step"}
    finally:
        dist.destroy_process_group()


def test_plain_steps_count_a_forced_plain_route(monkeypatch):
    """The forced plain route reports each frame of its loops to
    ``count_plain`` (here on the CPU, which it does not count, so the test
    takes the reports): both layers of both bands, T + 2 frames each."""
    from aec_tpu_torch.ops import lstm as ops_lstm

    before = profiling.counters()["lstm.plain_steps"]
    reported = []
    monkeypatch.setattr(ops_lstm, "count_plain", lambda x, steps: reported.append(steps))
    mic, far, near, echo = _batch()
    with torch.no_grad():
        fsn.fullsubnet_loss(_weights(), mic, far, near, echo, SMALL, train=True,
                            joint_kernel=False)
        frames = stft_mod.num_frames(N, SMALL.stft) + 2
        assert reported == [frames] * 4
        monkeypatch.undo()
        assert profiling.counters()["lstm.plain_steps"] == before  # a CPU tensor is not counted
