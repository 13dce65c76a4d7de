"""Port GRU (aec_tpu_torch.ops.gru, kernels.gru: K8's route) == JAX.

The fused route on a CPU tensor is the autograd Function over K8's plain
version; JAX's fused kernel runs in interpret mode, as its own suite runs
it (tests/test_pallas_gru.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.kernels.pallas_gru import _gru_scan_fused_fwd, gru_scan_fused as jax_gru_scan_fused
from aec_tpu.ops.gru import gru_scan as jax_gru_scan
from aec_tpu_torch.kernels.gru import (
    folded_projection,
    gru_recurrence,
    gru_recurrence_plain,
    gru_recurrence_split,
    gru_recurrence_wide_split,
    gru_scan_fused,
    gru_scan_fused_plain,
    lane_plan,
    pack_gru_lanes,
    pack_wide,
    unpack_gru_lanes,
    unpack_wide,
    wide_columns,
    wide_plan,
)
from aec_tpu_torch.ops.gru import gru_init, gru_scan

KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def _case(rng, b, t, i, h):
    """The same numpy parameters and inputs for both packages."""
    s = 1.0 / np.sqrt(h)
    params = {
        "w_ih": rng.uniform(-s, s, (3 * h, i)), "w_hh": rng.uniform(-s, s, (3 * h, h)),
        "b_ih": rng.uniform(-s, s, 3 * h), "b_hh": rng.uniform(-s, s, 3 * h),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((b, h))).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    return params, x, h0, jp, tp


@pytest.mark.parametrize("b,t,i,h", [(2, 20, 64, 32), (1, 70, 64, 32)])
def test_plain_scan_matches_jax(rng, b, t, i, h):
    _, x, h0, jp, tp = _case(rng, b, t, i, h)
    want, want_h = jax_gru_scan(jp, jnp.asarray(x), jnp.asarray(h0), fused=False)
    got, got_h = gru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0), fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-6)


@pytest.mark.parametrize("b,t,i,h", [(4, 37, 64, 32), (1, 70, 64, 32), (2, 5, 8, 8),
                                     (1, 12, 16, 160)])
def test_fused_route_matches_jax_kernel(rng, b, t, i, h):
    """The port's fused route on the CPU vs JAX's kernel in interpret mode:
    2e-6, the JAX suite's own bar (tests/test_pallas_gru.py:21)."""
    _, x, h0, jp, tp = _case(rng, b, t, i, h)
    want, want_h = _gru_scan_fused_fwd(jp, jnp.asarray(x), jnp.asarray(h0), interpret=True,
                                       unroll=4)
    before = gru_recurrence.launches
    with torch.no_grad():
        got, got_h = gru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0), fused=True)
        plain, _ = gru_scan_fused_plain(tp, torch.from_numpy(x), torch.from_numpy(h0))
    assert gru_recurrence.launches == before  # a CPU tensor never launches
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-6)


def test_fused_gradients_match_jax_custom_vjp(rng):
    """GruScanFused's backward vs jax.vjp of gru_scan_fused (its custom VJP
    recomputes through the scan): rtol 1e-5 / atol 1e-6, the JAX suite's
    bar (tests/test_pallas_gru.py:52)."""
    _, x, h0, jp, tp = _case(rng, 3, 11, 16, 8)
    g_ys = rng.standard_normal((3, 11, 8)).astype(np.float32)
    g_h = rng.standard_normal((3, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, xx, hh: jax_gru_scan_fused(p, xx, hh, True), jp, jnp.asarray(x),
                     jnp.asarray(h0))
    want_p, want_x, want_h0 = vjp((jnp.asarray(g_ys), jnp.asarray(g_h)))

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt, ht = torch.from_numpy(x).requires_grad_(), torch.from_numpy(h0).requires_grad_()
    ys, h_t = gru_scan(leaves, xt, ht, fused=True)
    got = torch.autograd.grad((ys, h_t), [xt, ht, *(leaves[k] for k in KEYS)],
                              (torch.from_numpy(g_ys), torch.from_numpy(g_h)))
    want = [want_x, want_h0, *(want_p[k] for k in KEYS)]
    for name, a, w in zip(("x", "h0", *KEYS), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)


def test_fused_function_reaches_gru_module_parameters(rng):
    """Gradients land on nn.GRU's own Parameters (LittleNet.gru_params()),
    equal to the plain scan's; an input that needs none gets none."""
    gru = torch.nn.GRU(16, 8, batch_first=True)
    params = {"w_ih": gru.weight_ih_l0, "w_hh": gru.weight_hh_l0, "b_ih": gru.bias_ih_l0,
              "b_hh": gru.bias_hh_l0}
    x = torch.from_numpy(rng.standard_normal((1, 9, 16)).astype(np.float32))
    for fused in (True, False):
        gru.zero_grad()
        ys, h_t = gru_scan(params, x, fused=fused)
        (ys.square().sum() + h_t.sum()).backward()
        grads = [p.grad.clone() for p in params.values()]
        if fused:
            fused_grads = grads
    for a, b in zip(fused_grads, grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert x.grad is None


def test_routing_on_cpu_takes_the_plain_loop(rng):
    """fused=None on a CPU tensor is the plain loop even at B == 1, T >= 64
    (the kernel route needs a CUDA tensor), and launches nothing."""
    _, x, h0, _, tp = _case(rng, 1, 80, 64, 32)
    before = gru_recurrence.launches
    with torch.no_grad():
        auto, _ = gru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0))
        plain, _ = gru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0), fused=False)
    assert torch.equal(auto, plain) and gru_recurrence.launches == before
    ys, h_t = gru_scan_fused(tp, torch.from_numpy(x))  # h0 defaults to zeros
    assert ys.shape == (1, 80, 32) and torch.equal(h_t, ys[:, -1])


@pytest.mark.parametrize("orthogonal", [True, False])
def test_gru_init_orthogonal_and_bounded(orthogonal):
    """Orthogonal weights (orthonormal columns of the (3H, I) and (3H, H)
    matrices) or U(+-1/sqrt(H)); biases in U(+-1/sqrt(H)); one seed, one
    draw."""
    hidden, inp = 32, 64
    p = gru_init(inp, hidden, orthogonal=orthogonal,
                 generator=torch.Generator().manual_seed(0), device="cpu")
    q = gru_init(inp, hidden, orthogonal=orthogonal,
                 generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in KEYS)
    assert p["w_ih"].shape == (3 * hidden, inp) and p["w_hh"].shape == (3 * hidden, hidden)
    bound = 1.0 / np.sqrt(hidden)
    for k in ("b_ih", "b_hh"):
        assert p[k].shape == (3 * hidden,) and float(p[k].abs().max()) <= bound
    for k in ("w_ih", "w_hh"):
        w = p[k]
        if orthogonal:
            torch.testing.assert_close(w.T @ w, torch.eye(w.shape[1]), atol=1e-5, rtol=0)
        else:
            assert float(w.abs().max()) <= bound


@pytest.mark.parametrize("rows,hidden,backward", [(1, 129, False), (1, 129, True),
                                                  (3, 160, False), (16, 300, True),
                                                  (2, 512, False), (16, 512, True)])
def test_pack_wide_layout(rows, hidden, backward):
    """The wide path's columns and their packing (K8 and K8b above H =
    128): forward column g U + j of CTA c is row g H + c U + j of W_hh,
    backward column j is column c U + j of W_hh; quad j cw + i of thread
    (ks ncg + cg) 32 + l holds quad l + 32 (ks pps + j) of column cg cw + i;
    unpack(pack) is the columns, zero past H and in the idle warps."""
    plan = wide_plan(rows, hidden, backward)
    w = torch.randn(3 * hidden, hidden, generator=torch.Generator().manual_seed(hidden))
    cols = wide_columns(w, plan)
    assert tuple(cols.shape) == (plan.nchunk, plan.ncg * plan.cw, plan.kp)
    u = plan.units
    for c in (0, plan.nchunk - 1):
        for j in range(u):
            unit = c * u + j
            if backward:
                want = [w[:, unit]] if unit < hidden else [torch.zeros(3 * hidden)]
            else:
                want = [w[g * hidden + unit] if unit < hidden else torch.zeros(hidden)
                        for g in range(3)]
            for g, col in enumerate(want):
                k = col.shape[0]
                assert torch.equal(cols[c, g * u + j, :k], col)
                assert not cols[c, g * u + j, k:].any()
    assert not cols[:, plan.columns:].any()
    packed = pack_wide(w, plan)
    assert tuple(packed.shape) == (plan.nchunk, plan.pps * plan.cw, 512, 4)
    assert torch.equal(unpack_wide(packed, plan), cols)
    quads = cols.reshape(plan.nchunk, plan.ncg * plan.cw, plan.kp // 4, 4)
    for warp in range(plan.ks * plan.ncg):
        ks, cg = divmod(warp, plan.ncg)
        for lane in (0, 31):
            for j in range(plan.pps):
                for i in range(plan.cw):
                    got = packed[:, j * plan.cw + i, warp * 32 + lane]
                    assert torch.equal(got, quads[:, cg * plan.cw + i, lane + 32 * (ks * plan.pps + j)])
    assert not packed[:, :, plan.ks * plan.ncg * 32:].any()


@pytest.mark.parametrize("b,hidden", [(2, 160), (3, 300)])
def test_wide_split_model_matches_plain_and_jax(rng, b, hidden):
    """The plain-torch model of the wide K8's summation order (each lane's
    quads in k order, a tree over the warp, the slices in order), from
    pack_wide's weights, against K8's plain recurrence (1e-6) and JAX's
    fused kernel in interpret mode (2e-6, the JAX suite's bar)."""
    _, x, h0, jp, tp = _case(rng, b, 12, 16, hidden)
    xp = folded_projection(tp, torch.from_numpy(x))
    b_hn = tp["b_hh"][2 * hidden:]
    plan = wide_plan(b, hidden, False)
    got = gru_recurrence_wide_split(xp, pack_wide(tp["w_hh"], plan), b_hn,
                                    torch.from_numpy(h0), plan)
    want = gru_recurrence_plain(xp, tp["w_hh"], b_hn, torch.from_numpy(h0))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    jax_ys, _ = _gru_scan_fused_fwd(jp, jnp.asarray(x), jnp.asarray(h0), interpret=True,
                                    unroll=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ys), atol=2e-6)


LANE_WIDTHS = [1, 7, 32, 64, 100, 128]


@pytest.mark.parametrize("hidden", LANE_WIDTHS)
def test_pack_gru_lanes_round_trip(hidden):
    """K8's register packing (H <= 128): unpack(pack(W_hh)) is W_hh, the
    layout is packed[g C/4 + i, j P + l, e] = W_hh[g H + j, 4 (l + P i) + e]
    and everything past H is zero."""
    w = torch.randn(3 * hidden, hidden, generator=torch.Generator().manual_seed(hidden))
    p, c, units = lane_plan(hidden)
    packed = pack_gru_lanes(w)
    assert tuple(packed.shape) == (3 * c // 4, units * p, 4)
    assert torch.equal(unpack_gru_lanes(packed, hidden), w)
    assert (units * p) % 32 == 0 and p * c >= hidden
    padded = torch.zeros(3, units, p * c)
    padded[:, :hidden, :hidden] = w.reshape(3, hidden, hidden)
    g = torch.arange(3)[:, None, None, None, None]
    i = torch.arange(c // 4)[None, :, None, None, None]
    j = torch.arange(units)[None, None, :, None, None]
    lane = torch.arange(p)[None, None, None, :, None]
    e = torch.arange(4)[None, None, None, None, :]
    want = padded[g, j, 4 * (lane + p * i) + e]
    got = packed.reshape(3, c // 4, units, p, 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("hidden", LANE_WIDTHS)
def test_split_dot_model_matches_plain(rng, hidden, b):
    """The plain-torch model of K8's summation order (each lane's float4
    chunks into two accumulators, the team summed by xor shuffles), from the
    packed weights, against K8's plain recurrence: 1e-6."""
    _, x, h0, _, tp = _case(rng, b, 9, 16, hidden)
    xp = folded_projection(tp, torch.from_numpy(x))
    b_hn = tp["b_hh"][2 * hidden:]
    got = gru_recurrence_split(xp, pack_gru_lanes(tp["w_hh"]), b_hn, torch.from_numpy(h0))
    want = gru_recurrence_plain(xp, tp["w_hh"], b_hn, torch.from_numpy(h0))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hidden", LANE_WIDTHS)
def test_split_dot_model_matches_jax_kernel(rng, hidden):
    """The same model against JAX's fused kernel in interpret mode (2e-6,
    the JAX suite's own bar, tests/test_pallas_gru.py:21)."""
    _, x, h0, jp, tp = _case(rng, 2, 7, 16, hidden)
    want, _ = _gru_scan_fused_fwd(jp, jnp.asarray(x), jnp.asarray(h0), interpret=True, unroll=4)
    xp = folded_projection(tp, torch.from_numpy(x))
    got = gru_recurrence_split(xp, pack_gru_lanes(tp["w_hh"]), tp["b_hh"][2 * hidden:],
                               torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
