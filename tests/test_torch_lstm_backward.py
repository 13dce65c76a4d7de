"""The LSTM backward of the port (kernels.lstm_bwd: K9b's plain version behind
ComplexLstmScanFused and FsnJointFused) == JAX's custom VJPs, and K9b's
on-chip layout.

The same numpy inputs go to both packages. JAX's fused kernels run in
interpret mode, as its own suite runs them (tests/test_pallas_lstm.py,
tests/test_pallas_fullsubnet.py); their backwards are ``jax.vjp`` of the
plain scans. On the CPU the port's fused routes run the kernels' plain
versions (K9 and K11 saving their gates, then K9b) and launch nothing."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aec_tpu.kernels.pallas_fullsubnet import fsn_joint_fused as jax_fsn_joint_fused
from aec_tpu.kernels.pallas_lstm import complex_lstm_scan_fused as jax_complex_lstm_scan_fused
from aec_tpu.models import fullsubnet as jf
from aec_tpu_torch.kernels import fullsubnet as kf
from aec_tpu_torch.kernels import lstm as kl
from aec_tpu_torch.kernels import lstm_bwd as kb
from aec_tpu_torch.models import fullsubnet as tf
from aec_tpu_torch.ops import lstm as tl

KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
H100 = (132, 232448)  # SMs, shared memory a CTA may have (bytes)


def _lstm_params(rng, i, h):
    s = 1.0 / np.sqrt(h)
    shapes = {"w_ih": (4 * h, i), "w_hh": (4 * h, h), "b_ih": (4 * h,), "b_hh": (4 * h,)}
    return {k: rng.uniform(-s, s, shp).astype(np.float32) for k, shp in shapes.items()}


def _worst_of_scale(got, want) -> tuple[float, str]:
    """The largest max|got - want| over the leaf's own scale, and its leaf."""
    errs = {}
    for name, a, w in zip(want, got, want.values()):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        w = np.asarray(w)
        assert a.shape == w.shape, name
        errs[name] = float(np.abs(a - w).max() / max(np.abs(w).max(), 1e-30))
    name = max(errs, key=errs.get)
    return errs[name], name


@pytest.mark.parametrize("b,i,h", [(1, 8, 8), (2, 12, 16)])
def test_dccrn_lstm_gradients_match_jax_custom_vjp(rng, b, i, h):
    """The grouped complex LSTM's gradients through K9's saving forward,
    K9b's plain version and the products, against ``jax.vjp`` of JAX's
    ``complex_lstm_scan_fused`` (its kernel in interpret mode): both inputs
    and the 8 parameters within 1e-5 of each leaf's scale, over 70 reverse
    steps (fp32 round-off of the same function in another order)."""
    t = 70
    params = {g: _lstm_params(rng, i, h) for g in ("real", "imag")}
    r, im = (rng.standard_normal((b, t, i)).astype(np.float32) for _ in range(2))
    g_r, g_i = (rng.standard_normal((b, t, h)).astype(np.float32) for _ in range(2))
    jp = jax.tree.map(jnp.asarray, params)
    _, vjp = jax.vjp(lambda p, x, y: jax_complex_lstm_scan_fused(p, (x, y), True), jp,
                     jnp.asarray(r), jnp.asarray(im))
    dp, dr, di = vjp((jnp.asarray(g_r), jnp.asarray(g_i)))
    want = {"real": dr, "imag": di, **{f"{g}.{k}": dp[g][k] for g in ("real", "imag")
                                       for k in KEYS}}
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    rt, it = torch.from_numpy(r).requires_grad_(), torch.from_numpy(im).requires_grad_()
    before = kl.grouped_lstm_recurrence.launches, kb.lstm_backward.launches
    out = kl.complex_lstm_scan_fused(tp, rt, it)
    got = torch.autograd.grad(out, [rt, it, *(tp[g][k] for g in ("real", "imag") for k in KEYS)],
                              (torch.from_numpy(g_r), torch.from_numpy(g_i)))
    assert (kl.grouped_lstm_recurrence.launches, kb.lstm_backward.launches) == before
    err, leaf = _worst_of_scale(got, want)
    assert err <= 1e-5, f"{leaf} off JAX's custom VJP by {err:.3e} of its scale"


def test_fullsubnet_joint_gradients_match_jax_custom_vjp(rng):
    """FullSubNet's joint recurrence at narrow widths (H_fb 32, H_sb 16, 161
    bins): the gradients through K11's saving forward, K9b's plain version
    over the sub band and then the full band, and the products, against
    ``jax.vjp`` of JAX's ``fsn_joint_fused`` (its kernel in interpret mode;
    one utterance a call, so the port's B = 2 is two calls there): both
    projections and the 5 weights the recurrence reads within 1e-5 of each
    leaf's scale."""
    cfg = jf.FullSubNetConfig(fb_hidden=32, sb_hidden=16)
    params = jf.fullsubnet_init(jax.random.PRNGKey(5), cfg)
    b, t, f = 2, 16, cfg.n_freqs
    xp_fb = (0.3 * rng.standard_normal((b, t, 4 * cfg.fb_hidden))).astype(np.float32)
    xp_sb = (0.3 * rng.standard_normal((b, t, f, 4 * cfg.sb_hidden))).astype(np.float32)
    g = rng.standard_normal((b, t, f, cfg.sb_hidden)).astype(np.float32)
    want = {"xp_fb": [], "xp_sb": [], **{f"{x}.{y}": 0.0 for x, y in kf._LEAVES}}
    for u in range(b):
        _, vjp = jax.vjp(lambda p, a, c: jax_fsn_joint_fused(p, a, c, True), params,
                         jnp.asarray(xp_fb[u]), jnp.asarray(xp_sb[u]))
        dp, da, dc = vjp(jnp.asarray(g[u]))
        want["xp_fb"].append(np.asarray(da))
        want["xp_sb"].append(np.asarray(dc))
        for x, y in kf._LEAVES:
            want[f"{x}.{y}"] = want[f"{x}.{y}"] + np.asarray(dp[x][y])
    want["xp_fb"], want["xp_sb"] = np.stack(want["xp_fb"]), np.stack(want["xp_sb"])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    a, c = (torch.from_numpy(v).requires_grad_() for v in (xp_fb, xp_sb))
    before = kf.joint_recurrence.launches, kb.lstm_backward.launches
    hs = kf.fsn_joint_fused(tp, a, c)
    got = torch.autograd.grad(hs, [a, c, *(tp[x][y] for x, y in kf._LEAVES)],
                              torch.from_numpy(g))
    assert (kf.joint_recurrence.launches, kb.lstm_backward.launches) == before
    err, leaf = _worst_of_scale(got, want)
    assert err <= 1e-5, f"{leaf} off JAX's custom VJP by {err:.3e} of its scale"


def _modeled_backward(*modes):
    """A stand-in for lstm_backward_plain that runs backward_modeled (K9b's
    layout and summation order) at the plan each call's mode (``modes`` in
    turn) takes on a card of 16 SMs (the default plan where the mode cannot
    hold the shape)."""

    def run(g_ys, saved, w):
        mode = modes[len(run.plans)]
        g, b, t, f, h = g_ys.shape
        w = w if w.ndim == 3 else w[None]  # one group's (4H, H)
        try:
            plan = kb._plan(mode, g, b * f, h, 16, H100[1])
        except ValueError:
            plan = kb.backward_plan(g, b * f, h, 16, H100[1])
        run.plans.append(plan.mode)
        rows = lambda a: a.transpose(2, 3).reshape(g, b * f, t, -1)  # noqa: E731
        d = kb.backward_modeled(rows(g_ys), rows(saved), kb.pack_backward(w, plan), plan)
        return d.reshape(g, b, f, t, 4 * h).transpose(2, 3)

    run.plans = []
    return run


@pytest.mark.parametrize("mode", kb.MODES)
def test_dccrn_gradients_through_the_modeled_kernel_match_jax_custom_vjp(rng, monkeypatch, mode):
    """The grouped complex LSTM's gradients with K9b's plain version
    replaced by its model at each plan (local, cluster, grid) against
    ``jax.vjp`` of JAX's ``complex_lstm_scan_fused``: within 1e-5 of each
    leaf's scale."""
    b, i, h, t = 2, 12, 16, 40
    params = {g: _lstm_params(rng, i, h) for g in ("real", "imag")}
    r, im = (rng.standard_normal((b, t, i)).astype(np.float32) for _ in range(2))
    g_r, g_i = (rng.standard_normal((b, t, h)).astype(np.float32) for _ in range(2))
    jp = jax.tree.map(jnp.asarray, params)
    _, vjp = jax.vjp(lambda p, x, y: jax_complex_lstm_scan_fused(p, (x, y), True), jp,
                     jnp.asarray(r), jnp.asarray(im))
    dp, dr, di = vjp((jnp.asarray(g_r), jnp.asarray(g_i)))
    want = {"real": dr, "imag": di, **{f"{g}.{k}": dp[g][k] for g in ("real", "imag")
                                       for k in KEYS}}
    modeled = _modeled_backward(mode)
    monkeypatch.setattr(kb, "lstm_backward_plain", modeled)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    rt, it = torch.from_numpy(r).requires_grad_(), torch.from_numpy(im).requires_grad_()
    out = kl.complex_lstm_scan_fused(tp, rt, it)
    got = torch.autograd.grad(out, [rt, it, *(tp[g][k] for g in ("real", "imag") for k in KEYS)],
                              (torch.from_numpy(g_r), torch.from_numpy(g_i)))
    assert modeled.plans == [mode]
    err, leaf = _worst_of_scale(got, want)
    assert err <= 1e-5, f"{leaf} off JAX's custom VJP by {err:.3e} of its scale"


def test_fullsubnet_gradients_through_the_modeled_kernel_match_jax_custom_vjp(rng, monkeypatch):
    """FullSubNet's joint recurrence (H_fb 32, H_sb 16, 161 bins) with K9b's
    plain version replaced by its model at the training paths' plans (the
    sub band local, the full band a cluster) against ``jax.vjp`` of JAX's
    ``fsn_joint_fused``: within 1e-5 of each leaf's scale."""
    cfg = jf.FullSubNetConfig(fb_hidden=32, sb_hidden=16)
    params = jf.fullsubnet_init(jax.random.PRNGKey(6), cfg)
    t, f = 12, cfg.n_freqs
    xp_fb = (0.3 * rng.standard_normal((1, t, 4 * cfg.fb_hidden))).astype(np.float32)
    xp_sb = (0.3 * rng.standard_normal((1, t, f, 4 * cfg.sb_hidden))).astype(np.float32)
    g = rng.standard_normal((1, t, f, cfg.sb_hidden)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, a, c: jax_fsn_joint_fused(p, a, c, True), params,
                     jnp.asarray(xp_fb[0]), jnp.asarray(xp_sb[0]))
    dp, da, dc = vjp(jnp.asarray(g[0]))
    want = {"xp_fb": np.asarray(da)[None], "xp_sb": np.asarray(dc)[None],
            **{f"{x}.{y}": np.asarray(dp[x][y]) for x, y in kf._LEAVES}}
    modeled = _modeled_backward("local", "cluster")
    monkeypatch.setattr(kb, "lstm_backward_plain", modeled)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    a, c = (torch.from_numpy(v).requires_grad_() for v in (xp_fb, xp_sb))
    hs = kf.fsn_joint_fused(tp, a, c)
    got = torch.autograd.grad(hs, [a, c, *(tp[x][y] for x, y in kf._LEAVES)],
                              torch.from_numpy(g))
    assert modeled.plans == ["local", "cluster"]  # the sub band, then the full band
    err, leaf = _worst_of_scale(got, want)
    assert err <= 1e-5, f"{leaf} off JAX's custom VJP by {err:.3e} of its scale"


def test_saving_forwards_leave_the_outputs_bit_equal(rng):
    """K9's and K11's plain versions with ``save`` give the same outputs bit
    for bit, and what they save is each step's activated gates and c (and,
    for K11, the embedding before its ReLU)."""
    h, t = 8, 9
    xp = torch.from_numpy(rng.standard_normal((2, 3, t, 4 * h)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.standard_normal((2, 4 * h, h))).astype(np.float32))
    ys = tl.grouped_lstm_recurrence_plain(xp, w)
    ys_s, saved = tl.grouped_lstm_recurrence_plain(xp, w, save=True)
    assert torch.equal(ys, ys_s) and saved.shape == (2, 3, t, 5 * h)
    i, f, g, o, c = torch.split(saved, h, dim=-1)
    h_prev = torch.cat([torch.zeros_like(ys[:, :, :1]), ys[:, :, :-1]], dim=2)
    pre = xp + h_prev @ w.transpose(1, 2)[:, None]
    for got, want in ((i, torch.sigmoid(pre[..., :h])), (f, torch.sigmoid(pre[..., h:2 * h])),
                      (g, torch.tanh(pre[..., 2 * h:3 * h])),
                      (o, torch.sigmoid(pre[..., 3 * h:]))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(ys, o * torch.tanh(c), rtol=0, atol=1e-6)

    cfg = tf.FullSubNetConfig(fb_hidden=12, sb_hidden=8)
    tp = tf.fullsubnet_init(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    xp_fb = torch.from_numpy((0.3 * rng.standard_normal((2, t, 48))).astype(np.float32))
    xp_sb = torch.from_numpy((0.3 * rng.standard_normal((2, t, 161, 32))).astype(np.float32))
    hs = kf.joint_recurrence(tp, xp_fb, xp_sb)
    hs_s, save_fb, emb_pre, save_sb = kf.joint_recurrence(tp, xp_fb, xp_sb, save=True)
    assert torch.equal(hs, hs_s)
    assert (save_fb.shape, emb_pre.shape, save_sb.shape) == ((2, t, 60), (2, t, 161),
                                                             (2, t, 161, 40))
    torch.testing.assert_close(hs, save_sb[..., 24:32] * torch.tanh(save_sb[..., 32:]), rtol=0,
                               atol=1e-6)
    h_fb = save_fb[..., 36:48] * torch.tanh(save_fb[..., 48:])
    torch.testing.assert_close(emb_pre, h_fb @ tp["fb_out"]["w"].T + tp["fb_out"]["b"], rtol=0,
                               atol=1e-6)


def test_backward_plain_is_the_recurrence_vjp(rng):
    """lstm_backward_plain's dxp is the gradient of the hoisted projection,
    against autograd of K9's plain version; in the (G, B, T, F, .) layout
    the F rows of a step are rows like any other."""
    h, t = 6, 11
    xp = torch.from_numpy(rng.standard_normal((2, 6, t, 4 * h)).astype(np.float32))
    w = torch.from_numpy((0.4 * rng.standard_normal((2, 4 * h, h))).astype(np.float32))
    g_ys = torch.from_numpy(rng.standard_normal((2, 6, t, h)).astype(np.float32))
    xl = xp.clone().requires_grad_()
    want = torch.autograd.grad(tl.grouped_lstm_recurrence_plain(xl, w), xl, g_ys)[0]
    _, saved = tl.grouped_lstm_recurrence_plain(xp, w, save=True)
    got = kb.lstm_backward_plain(g_ys[:, :, :, None], saved[:, :, :, None], w)[:, :, :, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the same six rows as B = 2 sequences of F = 3 rows a step
    lay = lambda a: a.reshape(2, 2, 3, t, -1).transpose(2, 3).contiguous()  # noqa: E731
    got5 = kb.lstm_backward_plain(lay(g_ys), lay(saved), w)
    torch.testing.assert_close(got5, lay(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- K9b's on-chip layout
# small cards (few SMs, little shared memory, few register quads) put W's
# quads in registers, shared memory and L2, and take all four plans


def _plans():
    return [
        # (G, R, H, SMs, shared memory, register quads, forced columns a warp)
        (2, 3, 8, 8, 232448, 16, None),     # local: every unit in a CTA, rows in runs
        (1, 7, 24, 4, 232448, 16, None),    # local, uneven runs
        (2, 3, 64, 4, 80000, 4, None),      # local, W in shared memory, two k-slices
        (2, 2, 96, 8, 150000, 4, None),     # cluster of 4: units in chunks, registers and smem
        (1, 2, 200, 4, 200000, 4, None),    # grid: some of W from L2
        (2, 4, 100, 6, 100000, 2, None),    # grid, all of W from L2, four k-slices
        (1, 3, 40, 4, 232448, 16, 2),       # cw = 2 cannot hold 40 units in a CTA: a cluster
        (2, 2, 64, 8, 232448, 16, 1),       # cw = 1: a cluster, 16 warps of a column
        (1, 6, 64, 16, 100000, 4, None),    # local, one row a run, W in shared memory
        (2, 5, 48, 16, 20000, 4, None),     # a cluster of 6 (no power of two)
        (1, 3, 100, 8, 100000, 4, None),    # a cluster of 7 chunks of 16: the last padded
        (1, 9, 30, 4, 232448, 16, None),    # H = 30 padded to 32: zero units in every gate
        (1, 5, 200, 8, 120000, 4, None),    # grid: the split plan's W does not fit 120 KB
        (2, 3, 600, 132, 232448, 16, None),  # split: 50 chunks of 12 units, two columns a thread
        (1, 18, 600, 132, 232448, 16, None),  # split, 18 rows: two passes of 16
    ]


def _padded(w, hidden):
    """W_hh (G, 4H, H) with zero units in every gate up to ``hidden``."""
    g, _, h = w.shape
    out = w.new_zeros((g, 4, hidden, hidden))
    out[:, :, :h, :h] = w.reshape(g, 4, h, h)
    return out.reshape(g, 4 * hidden, hidden)


@pytest.mark.parametrize("g,r,h,sms,smem,quads,cw", _plans())
def test_backward_layout_round_trips_and_model_matches_plain(rng, g, r, h, sms, smem, quads, cw):
    """pack_backward / unpack_backward reassemble W_hh exactly, and
    backward_modeled (the layout and the kernel's summation order: lanes in
    k order, the warp as a tree, the k-slices in order) agrees with the
    plain backward within 1e-5 of dxp's scale over 40 reverse steps; a
    forced ``cw`` (``kernels/lstm_bwd_costs.py``) is the plan's."""
    plan = kb.backward_plan(g, r, h, sms, smem, quads, cw)
    assert cw is None or plan.cw == cw
    assert plan.smem <= smem and plan.ctas <= max(sms, g)
    assert plan.smem == kb.plan_smem(plan.mode, plan.hidden, plan.run_rows, plan.block_rows,
                                     plan.units, plan.nchunk, plan.cw, plan.ks, plan.jsm,
                                     plan.round_rows, plan.nbuf)
    assert plan.hidden % 4 == 0 and plan.units % 4 == 0 and plan.hidden - h < 4
    assert plan.mode == "split" or (plan.cols >= plan.units
                                    and plan.ks * 32 * plan.npos >= plan.kquads >= plan.hidden)
    w = torch.from_numpy((0.4 * rng.standard_normal((g, 4 * h, h))).astype(np.float32))
    packed = kb.pack_backward(w, plan)
    assert packed.shape == ((g * plan.nchunk, 4 * plan.units, plan.cw, 512) if plan.mode == "split"
                            else (g * plan.nchunk, plan.npos * plan.cw, 512, 4))
    assert torch.equal(kb.unpack_backward(packed, plan), _padded(w, plan.hidden))
    t = 40
    xp = torch.from_numpy(rng.standard_normal((g, r, t, 4 * h)).astype(np.float32))
    g_ys = torch.from_numpy(rng.standard_normal((g, r, t, h)).astype(np.float32))
    _, saved = tl.grouped_lstm_recurrence_plain(xp, w, save=True)
    want = kb.lstm_backward_plain(g_ys[:, :, :, None], saved[:, :, :, None], w)[:, :, :, 0]
    got = kb.backward_modeled(g_ys, saved, packed, plan)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_backward_plans_take_both_routes():
    """Which plan the small cards above take, where W lies, and that every
    tier (registers, shared memory, L2) holds some of it in one of them:
    local plans split the rows into runs, cluster plans put a group's
    chunks in one cluster (chunk-major on chip: a last chunk's padding
    counts), split plans hold 4U k-values a CTA (all of them on chip), grid
    plans run without clusters."""
    plans = [kb.backward_plan(*p) for p in _plans()]
    assert [p.mode for p in plans] == ["local"] * 3 + ["cluster", "grid", "grid", "cluster",
                                                        "cluster", "local", "cluster", "cluster",
                                                        "local", "grid", "split", "split"]
    assert (plans[9].cluster, plans[10].cluster) == (6, 7)
    assert plans[10].kquads == 7 * 16 > plans[10].hidden
    for p in plans:
        assert (p.nchunk == 1) == (p.mode == "local") and (p.runs > 1) <= (p.mode == "local")
        assert p.cluster == (p.nchunk if p.mode == "cluster" else 1)
        assert p.mode != "split" or (p.npos == 4 * p.units and p.jreg + p.jsm == p.npos)
        assert p.mode != "grid" or (p.nbuf, p.round_rows) == (2, min(2, p.block_rows))
    assert any(p.jsm > 0 for p in plans)
    assert any(p.jreg + p.jsm < p.npos for p in plans)
    assert any(p.ks > 1 for p in plans) and any(p.cw < 16 for p in plans)


@pytest.mark.parametrize("g,r,h,mode,cluster,units,block_rows", [
    (2, 32, 1024, "split", 1, 16, 32), (1, 16 * 161, 96, "local", 1, 96, 20),
    (1, 16, 256, "cluster", 16, 16, 16), (2, 2, 1024, "split", 1, 16, 2),
    (1, 161, 96, "local", 1, 96, 2), (1, 1, 256, "cluster", 16, 16, 1)])
def test_backward_plans_at_the_training_shapes(g, r, h, mode, cluster, units, block_rows):
    """The H100 plans at the training paths' shapes (DCCRN at batch 16 and
    1; FullSubNet's sub band and full band at batch 16 and 1): each fits a
    CTA's shared memory, its grid the card's SMs, and holds all of W on
    chip; the sub band (H = 96) keeps every unit in a CTA (local), the full
    band (H = 256) is one cluster of 16 CTAs of 16 units, DCCRN (H = 1024)
    64 CTAs a group, each with the 64 rows of W_hh of its 16 units' gates
    (split: 24 k-values in registers, 40 in shared memory, two columns a
    thread)."""
    plan = kb.backward_plan(g, r, h, *H100)
    assert (plan.mode, plan.cluster, plan.units, plan.block_rows) == (mode, cluster, units,
                                                                     block_rows)
    assert plan.smem <= H100[1] and plan.ctas <= H100[0]
    assert plan.jreg + plan.jsm == plan.npos  # nothing read from L2
    assert plan.runs * plan.run_rows >= r and plan.nchunk * plan.units >= h
    assert plan.mode != "split" or (plan.cw, plan.jreg, plan.jsm) == (2, 24, 40)
    assert plan.mode != "cluster" or plan.cw == 4


@pytest.mark.parametrize("placed,cluster", [(16, 16), (8, 8), (4, 0), (1, 0)])
def test_card_plan_takes_the_widest_cluster_the_card_places(monkeypatch, placed, cluster):
    """On the H100's 132 SMs the full band (16 rows, H = 256) wants a
    cluster of 16 CTAs; card_plan asks the card (the kernel library's
    cudaOccupancyMaxActiveClusters) and takes the widest cluster it places,
    or, where it places none wide enough that W fits (4 CTAs would hold 256
    KB of W each), the split plan."""
    asked = []

    class Lib:
        @staticmethod
        def aec_lstm_bwd_clusters(size, smem, cw, index):
            asked.append(size)
            return 1 if size <= placed else 0

    props = types.SimpleNamespace(multi_processor_count=H100[0],
                                  shared_memory_per_block_optin=H100[1])
    monkeypatch.setattr(kb, "_lib", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda index: props)
    kb._card_plan.cache_clear()
    try:
        plan = kb.card_plan(1, 16, 256, torch.device("cuda", 0))
    finally:
        kb._card_plan.cache_clear()
    assert plan.cluster == max(cluster, 1) and plan.mode == ("cluster" if cluster else "split")
    assert asked[-1] == cluster or cluster == 0
    assert asked == sorted(asked, reverse=True) and asked[0] == 16


def test_backward_weights_are_packed_once_per_version():
    """K9b packs W_hh once per weight tensor (kernels/lstm.py's cache, keyed
    on data_ptr and _version beside K9's layout) and again after an in-place
    change."""
    kl.clear_cache()
    w = [torch.randn(64, 16) for _ in range(2)]
    plan = kb.backward_plan(2, 4, 16, 8, 232448)
    first = kl.packed_weights(w, plan, kb.pack_backward)
    assert kl.packed_weights(w, plan, kb.pack_backward) is first
    assert kl.packed_weights(w, kl.grouped_plan(2, 4, 16, 8, 232448), kl.pack_grouped) is not first
    w[1].mul_(2.0)
    second = kl.packed_weights(w, plan, kb.pack_backward)
    assert second is not first
    assert torch.equal(kb.unpack_backward(second, plan), torch.stack(w))
    kl.clear_cache()


def test_fullsubnet_module_gradients_use_the_fused_route(rng):
    """fullsubnet_masks' kernel route (K11 with its saving forward, K9b
    twice) against the plain joint loop differentiated by autograd, every
    leaf of the tree within 1e-5 of its scale."""
    cfg = tf.FullSubNetConfig(fb_hidden=16, sb_hidden=8)
    params = tf.fullsubnet_init(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    mic, ref = (torch.from_numpy(np.abs(rng.standard_normal((2, 20, 161))).astype(np.float32))
                for _ in range(2))
    grads = {}
    for jk in (None, False):
        leaves = {f"{a}.{k}": v.detach().clone().requires_grad_()
                  for a, sub in params.items() for k, v in sub.items()}
        tree = {}
        for name, v in leaves.items():
            a, k = name.split(".")
            tree.setdefault(a, {})[k] = v
        near, echo = tf.fullsubnet_masks(tree, mic, ref, cfg, joint_kernel=jk)
        grads[jk] = dict(zip(leaves, torch.autograd.grad((near * near).sum() + (echo * mic).sum(),
                                                         list(leaves.values()))))
    err, leaf = _worst_of_scale(list(grads[None].values()), grads[False])
    assert err <= 1e-5, f"{leaf} off the plain route by {err:.3e} of its scale"


def test_cost_variants_keep_the_plans_they_time():
    """``lstm_bwd_costs.keep_mask`` on the H100 keeps the kernel of every
    plan ``costs`` times (each shape at every cluster width ``card_plan``
    may narrow to) and nothing else; ``instantiation`` picks the rows a
    sweep as ``csrc/lstm_bwd.cu``'s ``bwd_launch_cw`` does."""
    from aec_tpu_torch.kernels import lstm_bwd_costs as kc

    def bit(mode, cw, rt):
        lg_cw, lg_rt = cw.bit_length() - 1, rt.bit_length() - 1
        return 60 + lg_cw if mode == kb.MODES.index("split") else mode * 20 + lg_cw * 4 + lg_rt

    want = {kc.instantiation(kb.backward_plan(g, b * f, h, *H100, max_cluster=w))
            for _, g, b, f, _, h in kc.SHAPES for w in range(kb.MAX_CLUSTER, 1, -1)}
    assert want == {(3, 2, 1), (0, 8, 4), (1, 4, 8), (3, 1, 1)}
    assert kc.keep_mask(*H100) == sum(1 << bit(*k) for k in want)
    plan = kb._plan("grid", 2, 32, 1024, *H100, cw=4)
    for rows, rt in ((1, 1), (2, 2), (3, 8)):  # a grid plan's rounds: 1, 2, else min(32 / CW, 8)
        assert kc.instantiation(types.SimpleNamespace(
            mode="grid", cw=plan.cw, round_rows=rows, block_rows=plan.block_rows)) == (2, 4, rt)
    local = types.SimpleNamespace(mode="local", cw=16, round_rows=0, block_rows=20)
    assert kc.instantiation(local) == (0, 16, 2)  # 32 / 16 rows a sweep, no 2-row special case
