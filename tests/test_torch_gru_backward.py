"""The GRU backward of the port (kernels.gru: K8b's plain version behind
GruScanFused) == JAX's custom VJP, and the route that takes K8 and K8b.

The same numpy inputs go to both packages. JAX's fused kernel runs in
interpret mode, as its own suite runs it (tests/test_pallas_gru.py); its
backward is ``jax.vjp`` of the plain scan. On the CPU the port's fused
route runs the kernels' plain versions and launches nothing."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aec_tpu.kernels.pallas_gru import gru_scan_fused as jax_gru_scan_fused
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.kernels.gru import (
    clear_cache,
    folded_projection,
    gru_backward,
    gru_backward_plain,
    gru_backward_split,
    gru_backward_wide_split,
    gru_recurrence,
    gru_recurrence_plain,
    gru_recurrence_wide_split,
    pack_gru_lanes,
    pack_wide,
    packed_lanes,
    packed_wide,
    unpack_gru_lanes,
    wide_fits,
    wide_plan,
)
from aec_tpu_torch.models import little_net as little_net_mod
from aec_tpu_torch.models.little_net import little_net_init, little_net_loss
from aec_tpu_torch.ops.gru import gru_init, gru_scan, kernel_route

KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
NAMES = ("x", "h0", *KEYS)


def _case(rng, b, t, i, h):
    """Parameters, input, h0 and the cotangents of ys and h_T, in numpy."""
    s = 1.0 / np.sqrt(h)
    params = {"w_ih": rng.uniform(-s, s, (3 * h, i)), "w_hh": rng.uniform(-s, s, (3 * h, h)),
              "b_ih": rng.uniform(-s, s, 3 * h), "b_hh": rng.uniform(-s, s, 3 * h)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((b, h))).astype(np.float32)
    g_ys = rng.standard_normal((b, t, h)).astype(np.float32)
    g_h = rng.standard_normal((b, h)).astype(np.float32)
    return params, x, h0, g_ys, g_h


def _port_grads(params, x, h0, g_ys, g_h, fused):
    """Gradients of (ys, h_T) with cotangents (g_ys, g_h) into x, h0 and the
    four parameters, through gru_scan's fused route or its plain loop."""
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt, ht = torch.from_numpy(x).requires_grad_(), torch.from_numpy(h0).requires_grad_()
    ys, h_t = gru_scan(leaves, xt, ht, fused=fused)
    return torch.autograd.grad((ys, h_t), [xt, ht, *(leaves[k] for k in KEYS)],
                               (torch.from_numpy(g_ys), torch.from_numpy(g_h)))


def _jax_grads(params, x, h0, g_ys, g_h):
    """jax.vjp of JAX's gru_scan_fused (its kernel in interpret mode)."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, vjp = jax.vjp(lambda p, xx, hh: jax_gru_scan_fused(p, xx, hh, True), jp, jnp.asarray(x),
                     jnp.asarray(h0))
    want_p, want_x, want_h0 = vjp((jnp.asarray(g_ys), jnp.asarray(g_h)))
    return [np.asarray(a) for a in (want_x, want_h0, *(want_p[k] for k in KEYS))]


def _worst_of_scale(got, want) -> tuple[float, str]:
    """The largest max|got - want| over the leaf's own scale, and its leaf."""
    errs = {n: float(np.abs(np.asarray(a) - w).max() / np.abs(w).max())
            for n, a, w in zip(NAMES, got, want)}
    name = max(errs, key=errs.get)
    return errs[name], name


def test_backward_matches_jax_custom_vjp_at_its_own_bar(rng):
    """The short case: every leaf, x and h0 at rtol 1e-5 / atol 1e-6, the
    JAX suite's bar for its custom VJP (tests/test_pallas_gru.py:52)."""
    params, x, h0, g_ys, g_h = _case(rng, 3, 11, 16, 8)
    want = _jax_grads(params, x, h0, g_ys, g_h)
    got = _port_grads(params, x, h0, g_ys, g_h, fused=True)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("b,t,i,h", [(4, 70, 64, 32), (2, 70, 64, 64), (2, 66, 32, 128)])
def test_backward_matches_jax_custom_vjp_and_plain_loop(rng, b, t, i, h):
    """Longer scans on K8b's two lane plans (one lane a unit to H = 32, a
    team of four above): every leaf within 1e-5 of its scale of JAX's custom
    VJP and of the plain loop's autograd (fp32 round-off carried through
    66-70 reverse steps in another order)."""
    params, x, h0, g_ys, g_h = _case(rng, b, t, i, h)
    got = _port_grads(params, x, h0, g_ys, g_h, fused=True)
    plain = [a.numpy() for a in _port_grads(params, x, h0, g_ys, g_h, fused=False)]
    for want, what in ((_jax_grads(params, x, h0, g_ys, g_h), "JAX"), (plain, "plain loop")):
        err, leaf = _worst_of_scale(got, want)
        assert err <= 1e-5, f"{leaf} off {what} by {err:.3e} of its scale"


def test_backward_on_cpu_tensors_launches_nothing(rng):
    """A CPU tensor takes the plain versions of K8 and K8b."""
    params, x, h0, g_ys, g_h = _case(rng, 2, 70, 16, 32)
    before = gru_recurrence.launches, gru_backward.launches
    _port_grads(params, x, h0, g_ys, g_h, fused=True)
    assert (gru_recurrence.launches, gru_backward.launches) == before


def test_saved_gates_leave_the_forward_bit_equal(rng):
    """K8's plain version with the gates saved gives the same ys, and the
    gates are r, z, n and h W_hn^T + b_hn of each step."""
    params, x, h0, _, _ = _case(rng, 2, 9, 16, 8)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    xp, h0t = folded_projection(tp, torch.from_numpy(x)), torch.from_numpy(h0)
    b_hn = tp["b_hh"][16:]
    ys = gru_recurrence_plain(xp, tp["w_hh"], b_hn, h0t)
    ys_s, gates = gru_recurrence_plain(xp, tp["w_hh"], b_hn, h0t, save=True)
    assert torch.equal(ys, ys_s) and gates.shape == (2, 9, 32)
    h_prev = torch.cat([h0t[:, None], ys[:, :-1]], dim=1)
    hp = h_prev @ tp["w_hh"].T
    r, z, n, hn = torch.split(gates, 8, dim=-1)
    torch.testing.assert_close(r, torch.sigmoid(xp[..., :8] + hp[..., :8]), rtol=0, atol=1e-6)
    torch.testing.assert_close(z, torch.sigmoid(xp[..., 8:16] + hp[..., 8:16]), rtol=0, atol=1e-6)
    torch.testing.assert_close(hn, hp[..., 16:] + b_hn, rtol=0, atol=1e-6)
    torch.testing.assert_close(n, torch.tanh(xp[..., 16:] + r * hn), rtol=0, atol=1e-6)


def test_backward_plain_is_the_recurrence_vjp(rng):
    """gru_backward_plain's outputs are the recurrence's gradients: dxp into
    the folded projection, dh0 into h0, and d_hn summed over B and T into
    b_hn, against autograd of K8's plain version."""
    params, x, h0, g_ys, _ = _case(rng, 3, 13, 16, 8)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    xp = folded_projection(tp, torch.from_numpy(x)).requires_grad_()
    h0t = torch.from_numpy(h0).requires_grad_()
    b_hn = tp["b_hh"][16:].clone().requires_grad_()
    ys, gates = gru_recurrence_plain(xp, tp["w_hh"], b_hn, h0t, save=True)
    want = torch.autograd.grad(ys, [xp, h0t, b_hn], torch.from_numpy(g_ys))
    dxp, dhn, dh0 = gru_backward_plain(torch.from_numpy(g_ys), gates.detach(), ys.detach(),
                                       h0t.detach(), tp["w_hh"])
    for got, w in ((dxp, want[0]), (dh0, want[1]), (dhn.sum((0, 1)), want[2])):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hidden", [7, 32, 64, 128])
def test_packed_lanes_are_cached_per_weight_version(hidden):
    """K8's and K8b's register layouts: pack_gru_lanes of W_hh and of its
    per-gate transpose, packed once per weight tensor and packed again after
    an in-place change (an optimizer step bumps ``_version``)."""
    clear_cache()
    w = torch.randn(3 * hidden, hidden, generator=torch.Generator().manual_seed(hidden))
    w_t = w.reshape(3, hidden, hidden).transpose(1, 2).reshape(3 * hidden, hidden)
    k8, k8b = packed_lanes(w), packed_lanes(w, transposed=True)
    assert torch.equal(k8, pack_gru_lanes(w)) and torch.equal(k8b, pack_gru_lanes(w_t))
    assert packed_lanes(w) is k8 and packed_lanes(w, transposed=True) is k8b
    with torch.no_grad():
        w.mul_(0.5)
    again = packed_lanes(w)
    assert again is not k8 and torch.equal(again, pack_gru_lanes(w))
    clear_cache()
    assert packed_lanes(w) is not again


@pytest.mark.parametrize("hidden", [32, 64, 128])
def test_backward_model_in_the_kernels_order_matches_plain_and_jax(rng, monkeypatch, hidden):
    """K8b's layout and summation order (gru_backward_split, from the packing
    of W_hh's per-gate transpose, which at H = 128 the kernel splits between
    registers and shared memory): the packing round-trips, the model agrees
    with gru_backward_plain within 1e-5 of each output's scale over 60
    reverse steps, and the fused route with the model in K8b's place agrees
    with JAX's custom VJP (pallas_gru.py:159-166) within 1e-5 of each leaf's
    scale."""
    w_hh = (rng.uniform(-1, 1, (3 * hidden, hidden)) / np.sqrt(hidden)).astype(np.float32)
    w = torch.from_numpy(w_hh)
    w_t = w.reshape(3, hidden, hidden).transpose(1, 2).reshape(3 * hidden, hidden)
    packed = pack_gru_lanes(w_t)
    assert torch.equal(unpack_gru_lanes(packed, hidden), w_t)
    b, t = 3, 60
    xp = torch.from_numpy(rng.standard_normal((b, t, 3 * hidden)).astype(np.float32))
    b_hn = torch.from_numpy((0.1 * rng.standard_normal(hidden)).astype(np.float32))
    h0 = torch.from_numpy((0.5 * rng.standard_normal((b, hidden))).astype(np.float32))
    g_ys = torch.from_numpy(rng.standard_normal((b, t, hidden)).astype(np.float32))
    ys, gates = gru_recurrence_plain(xp, w, b_hn, h0, save=True)
    got = gru_backward_split(g_ys, gates, ys, h0, packed)
    for a, want in zip(got, gru_backward_plain(g_ys, gates, ys, h0, w)):
        assert float((a - want).abs().max()) <= 1e-5 * float(want.abs().max())

    def modeled(g_ys, gates, ys, h0, w_hh):
        w_t = w_hh.reshape(3, hidden, hidden).transpose(1, 2).reshape(3 * hidden, hidden)
        modeled.calls += 1
        return gru_backward_split(g_ys, gates, ys, h0, pack_gru_lanes(w_t))

    modeled.calls = 0
    import aec_tpu_torch.kernels.gru as kg
    monkeypatch.setattr(kg, "gru_backward_plain", modeled)
    params, x, h0n, gy, g_h = _case(rng, 2, 66, 32, hidden)
    got = _port_grads(params, x, h0n, gy, g_h, fused=True)
    assert modeled.calls == 1
    err, leaf = _worst_of_scale(got, _jax_grads(params, x, h0n, gy, g_h))
    assert err <= 1e-5, f"{leaf} off JAX's custom VJP by {err:.3e} of its scale"


@pytest.mark.parametrize("b,t,h", [(2, 70, 160), (3, 12, 300)])
def test_wide_backward_matches_jax_custom_vjp_and_plain_loop(rng, b, t, h):
    """Above H = 128 (the wide path) the fused route saves the gates and
    runs K8b's plain version on them, as at every width: every leaf within
    1e-5 of its scale of JAX's custom VJP (its kernel in interpret mode) and
    of the plain loop's autograd."""
    params, x, h0, g_ys, g_h = _case(rng, b, t, 16, h)
    got = _port_grads(params, x, h0, g_ys, g_h, fused=True)
    plain = [a.numpy() for a in _port_grads(params, x, h0, g_ys, g_h, fused=False)]
    for want, what in ((_jax_grads(params, x, h0, g_ys, g_h), "JAX"), (plain, "plain loop")):
        err, leaf = _worst_of_scale(got, want)
        assert err <= 1e-5, f"{leaf} off {what} by {err:.3e} of its scale"


@pytest.mark.parametrize("b,t,h", [(2, 40, 160), (3, 12, 300)])
def test_wide_models_in_the_kernels_order_match_plain_and_jax(rng, monkeypatch, b, t, h):
    """The wide path's summation order (gru_recurrence_wide_split,
    gru_backward_wide_split, from pack_wide's weights): the backward model
    within 1e-5 of each output's scale of gru_backward_plain, the forward
    model's saved-gate contract unchanged (ys the plain version's to 1e-6),
    and the fused route with both models in K8's and K8b's places within
    1e-5 of each leaf's scale of JAX's custom VJP."""
    w = torch.from_numpy((rng.uniform(-1, 1, (3 * h, h)) / np.sqrt(h)).astype(np.float32))
    xp = torch.from_numpy(rng.standard_normal((b, t, 3 * h)).astype(np.float32))
    b_hn = torch.from_numpy((0.1 * rng.standard_normal(h)).astype(np.float32))
    h0 = torch.from_numpy((0.5 * rng.standard_normal((b, h))).astype(np.float32))
    g_ys = torch.from_numpy(rng.standard_normal((b, t, h)).astype(np.float32))
    ys, gates = gru_recurrence_plain(xp, w, b_hn, h0, save=True)
    bwd = wide_plan(b, h, True)
    got = gru_backward_wide_split(g_ys, gates, ys, h0, pack_wide(w, bwd), bwd)
    for a, want in zip(got, gru_backward_plain(g_ys, gates, ys, h0, w)):
        assert float((a - want).abs().max()) <= 1e-5 * float(want.abs().max())

    calls = []

    def forward(xp, w_hh, b_hn, h0, *, save=False):
        calls.append("K8")
        plan = wide_plan(h0.shape[0], h0.shape[-1], False)
        ys = gru_recurrence_wide_split(xp, pack_wide(w_hh, plan), b_hn, h0, plan)
        plain_ys, gates = gru_recurrence_plain(xp, w_hh, b_hn, h0, save=True)
        torch.testing.assert_close(ys, plain_ys, atol=1e-6, rtol=0)
        return (ys, gates) if save else ys

    def backward(g_ys, gates, ys, h0, w_hh):
        calls.append("K8b")
        plan = wide_plan(h0.shape[0], h0.shape[-1], True)
        return gru_backward_wide_split(g_ys, gates, ys, h0, pack_wide(w_hh, plan), plan)

    import aec_tpu_torch.kernels.gru as kg
    monkeypatch.setattr(kg, "gru_recurrence_plain", forward)
    monkeypatch.setattr(kg, "gru_backward_plain", backward)
    params, x, h0n, gy, g_h = _case(rng, b, t, 16, h)
    got = _port_grads(params, x, h0n, gy, g_h, fused=True)
    assert calls == ["K8", "K8b"]
    err, leaf = _worst_of_scale(got, _jax_grads(params, x, h0n, gy, g_h))
    assert err <= 1e-5, f"{leaf} off JAX's custom VJP by {err:.3e} of its scale"


def test_wide_saved_gates_leave_the_forward_bit_equal(rng):
    """At H > 128 K8's plain version with the gates saved gives the same
    ys, bit for bit (the kernels' contract at every width)."""
    params, x, h0, _, _ = _case(rng, 2, 9, 16, 160)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    xp, h0t = folded_projection(tp, torch.from_numpy(x)), torch.from_numpy(h0)
    ys = gru_recurrence_plain(xp, tp["w_hh"], tp["b_hh"][320:], h0t)
    ys_s, gates = gru_recurrence_plain(xp, tp["w_hh"], tp["b_hh"][320:], h0t, save=True)
    assert torch.equal(ys, ys_s) and gates.shape == (2, 9, 640)


def test_packed_wide_is_cached_per_weight_version():
    """The wide path's packings (forward and backward plans) are built once
    per weight tensor and again after an in-place change."""
    clear_cache()
    w = torch.randn(3 * 160, 160, generator=torch.Generator().manual_seed(160))
    fwd, bwd = wide_plan(16, 160, False), wide_plan(16, 160, True)
    a, b = packed_wide(w, fwd), packed_wide(w, bwd)
    assert torch.equal(a, pack_wide(w, fwd)) and torch.equal(b, pack_wide(w, bwd))
    assert packed_wide(w, fwd) is a and packed_wide(w, bwd) is b
    with torch.no_grad():
        w.mul_(0.5)
    again = packed_wide(w, fwd)
    assert again is not a and torch.equal(again, pack_wide(w, fwd))
    clear_cache()


def test_little_net_loss_gradient_fused_matches_plain(rng, monkeypatch):
    """LittleNet's loss at B = 4 x 65 frames: the gradient of every
    parameter through the fused route (K8's and K8b's plain versions)
    within 1e-5 of its scale of the plain loop's."""
    n = 64 * 256
    mic, far, near = (torch.from_numpy(0.1 * rng.standard_normal((4, n)).astype(np.float32))
                      for _ in range(3))
    erb = torch.from_numpy(erb_filterbank())
    grads = {}
    for fused in (True, False):
        net = little_net_init(generator=torch.Generator().manual_seed(0), device="cpu")
        monkeypatch.setattr(little_net_mod, "gru_scan", functools.partial(gru_scan, fused=fused))
        loss, _ = little_net_loss(net, mic, far, near, erb, sqrt_eps=1e-12)
        grads[fused] = torch.autograd.grad(loss, list(net.parameters()))
    for a, w in zip(grads[True], grads[False]):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("b,t,h,device,want", [
    (1, 64, 32, "cuda", True),     # JAX's route: a single stream, a long scan
    (16, 501, 32, "cuda", True),   # a LittleNet train step (K8 and K8b)
    (8, 501, 32, "cuda", True),    # batch_enhance --batch 8
    (16, 501, 64, "cuda", True),   # a TwoLayerGRU train step
    (16, 501, 128, "cuda", True),  # K8's widest register path
    (16, 501, 129, "cuda", True),  # the wide path (K8 and K8b) at a training batch
    (16, 501, 512, "cuda", True),  # the DCT-CNN's step
    (1, 501, 512, "cuda", True),   # ... and its batch-1 validation
    (36, 501, 512, "cuda", True),  # the widest batch the wide plan holds at H = 512
    (37, 501, 512, "cuda", False),  # K8b's vectors past a CTA's shared memory
    (1, 501, 2048, "cuda", False),  # more columns a CTA than its warps
    (16, 63, 32, "cuda", False),   # a short scan
    (1, 1001, 32, "cpu", False),   # a CPU tensor never launches
    (16, 501, 32, "cpu", False),
])
def test_route_decision(b, t, h, device, want):
    assert kernel_route(b, t, h, device) is want
    if device == "cuda" and t >= 64 and h > 128:
        assert wide_fits(b, h) is want


def test_route_on_cpu_is_the_plain_loop(rng):
    """fused=None on a CPU tensor at a batch K8 takes on the card: the
    plain loop, bit for bit, and no launch either way."""
    params, x, h0, _, _ = _case(rng, 4, 70, 16, 32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    before = gru_recurrence.launches, gru_backward.launches
    with torch.no_grad():
        auto, _ = gru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0))
        plain, _ = gru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0), fused=False)
    assert torch.equal(auto, plain)
    assert (gru_recurrence.launches, gru_backward.launches) == before


def test_gru_init_net_trains_through_the_fused_function(rng):
    """A gru_init net's parameters as leaves: the fused route's gradients
    reach every one, and an input that needs none gets none."""
    p = gru_init(16, 8, generator=torch.Generator().manual_seed(1), device="cpu")
    leaves = {k: v.requires_grad_() for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((2, 70, 16)).astype(np.float32))
    ys, h_t = gru_scan(leaves, x, fused=True)
    (ys.square().sum() + h_t.sum()).backward()
    assert all(v.grad is not None and bool(torch.isfinite(v.grad).all()) for v in leaves.values())
    assert x.grad is None
