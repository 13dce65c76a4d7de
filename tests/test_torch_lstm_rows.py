"""K13 (``kernels/lstm_rows.py``, ``csrc/lstm_rows.cu``): the many-row LSTM
layer FullSubNet's published sub band runs on.

On the CPU: the plan, both packings of W_hh against their definitions, and
the route by rows. On the card (marker ``cuda``): the forward with and
without saving and the backward against the plain recurrence and K9b's
plain backward at the training cell's shapes (2,048 rows x 503 frames, H =
384) and at inference's (1 x 257 rows), the full band's 16 rows at H = 512
on K9 / K9b, the layer Function's gradients, and a published training
step that runs no plain loop.

The file imports neither JAX nor the JAX package, so on a machine with the
card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lstm_rows.py
"""

from __future__ import annotations

import pytest
import torch

from aec_tpu_torch.kernels import lstm_rows as k13
from aec_tpu_torch.kernels.lstm_bwd import lstm_backward_plain
from aec_tpu_torch.ops.lstm import count_plain, grouped_lstm_recurrence_plain


@pytest.mark.parametrize("hidden", [12, 128, 384, 500])
def test_plan_pads_to_whole_tiles(hidden):
    plan = k13.rows_plan(hidden)
    assert plan.upt == -(-hidden // 128) and plan.units == 128 * plan.upt >= hidden
    assert plan.kp % k13.TILE_K == 0 and hidden <= plan.kp < hidden + k13.TILE_K
    q = k13.tile_quads(hidden)
    assert plan.kq % q == 0 and hidden <= plan.kq < hidden + q
    assert plan.smem(False) <= 227 * 1024 and plan.smem(True) <= 227 * 1024


def test_plan_refuses_past_four_lanes():
    with pytest.raises(ValueError):
        k13.rows_plan(513)


@pytest.mark.parametrize("hidden", [12, 130])
def test_packings_are_their_definitions(hidden):
    g = torch.Generator().manual_seed(hidden)
    w = torch.randn(4 * hidden, hidden, generator=g)
    plan = k13.rows_plan(hidden)
    fwd = k13.pack_forward(w[None], plan)
    bwd = k13.pack_backward(w[None], plan)
    assert fwd.shape == (plan.kp, plan.units, 4) and bwd.shape == (plan.kq, plan.units, 4)
    for k in (0, hidden - 1):
        for u in (0, hidden // 2, hidden - 1):
            assert torch.equal(fwd[k, u], w[[u, hidden + u, 2 * hidden + u, 3 * hidden + u], k])
    for q in (0, hidden - 1):
        for u in (0, hidden - 1):
            assert torch.equal(bwd[q, u], w[4 * q:4 * q + 4, u])
    assert not fwd[hidden:].any() and not fwd[:, hidden:].any()
    assert not bwd[hidden:].any() and not bwd[:, hidden:].any()


def test_route_by_rows():
    assert k13.layer_route(16) == "grouped" and k13.layer_route(k13.FEW_ROWS) == "grouped"
    assert k13.layer_route(k13.FEW_ROWS + 1) == "rows" and k13.layer_route(2048) == "rows"


@pytest.mark.parametrize("rows,t", [(2048, 503), (2050, 503), (33, 1000), (16, 503)])
def test_rows_product_is_the_whole_product(rows, t):
    """The weight gradients' blocked sum over whole rows (with a remainder
    past the last full block, or one block) is ``a^T b``; in float64 the
    orders agree to round-off."""
    g = torch.Generator().manual_seed(rows)
    a = torch.randn(rows * t, 6, generator=g, dtype=torch.float64)
    b = torch.randn(rows * t, 5, generator=g, dtype=torch.float64)
    torch.testing.assert_close(k13.rows_product(a, b, rows), a.T @ b, rtol=1e-12, atol=1e-9)


def test_cpu_wrappers_are_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    xp = torch.randn(5, 7, 4 * 6, generator=g)
    w = torch.randn(24, 6, generator=g) * 0.3
    ys, saved = k13.rows_recurrence(xp, w, save=True)
    want, want_s = grouped_lstm_recurrence_plain(xp[None], w[None], True)
    assert torch.equal(ys, want[0]) and torch.equal(saved, want_s[0])
    g_ys = torch.randn(5, 7, 6, generator=g)
    dxp = k13.rows_backward(g_ys, saved, w)
    assert torch.equal(dxp, lstm_backward_plain(g_ys[None, :, :, None], saved[None, :, :, None],
                                                w[None])[0, :, :, 0])


# ----------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(dev, rows, t, hidden, inputs, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    b = hidden ** -0.5
    w_hh = (torch.rand(4 * hidden, hidden, generator=g, device=dev) * 2 - 1) * b
    x = torch.rand(rows, t, inputs, generator=g, device=dev) * 2
    w_ih = (torch.rand(4 * hidden, inputs, generator=g, device=dev) * 2 - 1) * b
    xp = (x.reshape(rows * t, -1) @ w_ih.T).reshape(rows, t, -1).contiguous()
    return xp, w_hh


# A 503-step fp32 recurrence summed in another order than the plain loop's:
# h in (-1, 1), its gap to the plain route grows with the steps; 2e-5 is
# about 170 float32 ulps of 1. The backward's dxp, over its largest
# element, is held to 1e-4 (carried dh and dc summed 503 steps back).
FWD_ATOL, BWD_RTOL = 2e-5, 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t,hidden,inputs", [(2048, 503, 384, 63), (257, 503, 384, 384),
                                                  (40, 70, 130, 20)])
def test_k13_against_the_plain_versions(cuda, rows, t, hidden, inputs):
    """Forward (with and without saving, the same bits) and backward
    against the plain recurrence and K9b's plain backward."""
    xp, w_hh = _layer(cuda, rows, t, hidden, inputs, rows)
    launched = k13.rows_recurrence.launches
    ys, saved = k13.rows_recurrence(xp, w_hh, save=True)
    assert torch.equal(ys, k13.rows_recurrence(xp, w_hh))
    assert k13.rows_recurrence.launches == launched + 2
    want, want_s = grouped_lstm_recurrence_plain(xp[None], w_hh[None], True)
    assert float((ys - want[0]).abs().max()) <= FWD_ATOL
    assert float((saved - want_s[0]).abs().max()) <= 50 * FWD_ATOL  # c grows past 1
    g = torch.Generator(device=cuda).manual_seed(1)
    g_ys = torch.randn(rows, t, hidden, generator=g, device=cuda) * 1e-3
    dxp = k13.rows_backward(g_ys, saved, w_hh)
    ref = lstm_backward_plain(g_ys[None, :, :, None], saved[None, :, :, None], w_hh[None])
    ref = ref[0, :, :, 0]
    assert float((dxp - ref).abs().max()) <= BWD_RTOL * float(ref.abs().max())


@pytest.mark.cuda
def test_full_band_rows_take_k9_and_k9b(cuda):
    """16 rows at H = 512 (the full band) route to K9 and K9b as one group."""
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward

    xp, w_hh = _layer(cuda, 16, 503, 512, 257, 5)
    fwd, bwd = grouped_lstm_recurrence.launches, lstm_backward.launches
    ys, saved = k13._recurrence(xp, w_hh, True)
    assert grouped_lstm_recurrence.launches == fwd + 1
    want, _ = grouped_lstm_recurrence_plain(xp[None], w_hh[None], True)
    assert float((ys - want[0]).abs().max()) <= FWD_ATOL
    g_ys = torch.randn(16, 503, 512, device=cuda) * 1e-3
    dxp = k13._backward(g_ys, saved, w_hh)
    assert lstm_backward.launches == bwd + 1
    ref = lstm_backward_plain(g_ys[None, :, :, None], saved[None, :, :, None], w_hh[None])
    assert float((dxp - ref[0, :, :, 0]).abs().max()) <= BWD_RTOL * float(ref.abs().max())


@pytest.mark.cuda
def test_published_step_runs_no_plain_loop(cuda):
    """A published training step at B = 2 x 4 s: both bands on kernels,
    ``lstm.plain_steps`` unmoved, the loss and gradients against the plain
    route's."""
    from aec_tpu_torch.models import fullsubnet as fsn

    cfg = fsn.FullSubNetConfig.published()
    p = fsn.fullsubnet_init(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    flat = [t.requires_grad_(True) for d in p.values()
            for t in (v for layer in (d if isinstance(d, list) else [d]) for v in layer.values())]
    g = torch.Generator(device=cuda).manual_seed(2)
    batch = [torch.randn(2, 64000, generator=g, device=cuda) * 0.3 for _ in range(4)]
    before, rows = count_plain.steps, k13.rows_backward.launches
    loss, _ = fsn.fullsubnet_loss(p, *batch, cfg, train=True)
    grads = torch.autograd.grad(loss, flat)
    assert count_plain.steps == before and k13.rows_backward.launches == rows + 2
    plain, _ = fsn.fullsubnet_loss(p, *batch, cfg, train=True, joint_kernel=False)
    want = torch.autograd.grad(plain, flat)
    assert count_plain.steps > before
    assert abs(float(loss) - float(plain)) <= 1e-5 * abs(float(plain))
    for a, b in zip(grads, want):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
