"""Port LSTM (aec_tpu_torch.ops.lstm, kernels.lstm: K9's route) == JAX.

The same numpy parameters and inputs go to both packages. The fused route on
a CPU tensor is the autograd Function over K9's plain version; JAX's fused
kernel runs in interpret mode, as its own suite runs it
(tests/test_pallas_lstm.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.kernels.pallas_lstm import _grouped_lstm_fused_fwd, lstm_int8_fused
from aec_tpu.ops import lstm as jl
from aec_tpu_torch.kernels import lstm as kl
from aec_tpu_torch.kernels import lstm_int8 as k10
from aec_tpu_torch.ops import lstm as tl

KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")


def _lstm_params(rng, i, h):
    s = 1.0 / np.sqrt(h)
    shapes = {"w_ih": (4 * h, i), "w_hh": (4 * h, h), "b_ih": (4 * h,), "b_hh": (4 * h,)}
    return {k: rng.uniform(-s, s, shp).astype(np.float32) for k, shp in shapes.items()}


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def _complex_case(rng, b, t, i, h):
    params = {g: _lstm_params(rng, i, h) for g in ("real", "imag")}
    r = rng.standard_normal((b, t, i)).astype(np.float32)
    im = rng.standard_normal((b, t, i)).astype(np.float32)
    return params, r, im


def test_init_shapes_and_bound():
    g = torch.Generator().manual_seed(0)
    p = tl.lstm_init(6, 8, generator=g, device="cpu")
    want = jl.lstm_init(jax.random.PRNGKey(0), 6, 8)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}
    assert all(float(v.abs().max()) <= 1.0 / np.sqrt(8) for v in p.values())
    cp = tl.complex_lstm_init(16, 12, generator=g, device="cpu")
    assert tuple(cp["imag"]["w_hh"].shape) == (24, 6)


def test_quantize_rows_int8_matches_jax(rng):
    w = rng.standard_normal((16, 12)).astype(np.float32)
    w[3] = 0.0  # a zero row takes the 1e-12 floor
    q_j, s_j = jl.quantize_rows_int8(jnp.asarray(w))
    q_t, s_t = tl.quantize_rows_int8(torch.from_numpy(w))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_lstm_cell_matches_jax(rng):
    p = _lstm_params(rng, 6, 8)
    h, c, xp = (rng.standard_normal((3, n)).astype(np.float32) for n in (8, 8, 32))
    jp, tp = _both(p)
    hj, cj = jl.lstm_cell(jp, jnp.asarray(h), jnp.asarray(c), jnp.asarray(xp))
    ht, ct = tl.lstm_cell(tp, torch.from_numpy(h), torch.from_numpy(c), torch.from_numpy(xp))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)


@pytest.mark.parametrize("state", [False, True])
def test_lstm_scan_fp32_matches_jax(rng, state):
    """fp32 on both sides (None is fp32 off the TPU in JAX, everywhere in
    the port): fp32 round-off, 1e-5."""
    p = _lstm_params(rng, 6, 8)
    x = rng.standard_normal((2, 20, 6)).astype(np.float32)
    h0 = c0 = None
    if state:
        h0, c0 = (0.5 * rng.standard_normal((2, 8))).astype(np.float32), rng.standard_normal(
            (2, 8)).astype(np.float32)
    jp, tp = _both(p)
    yj, (hj, cj) = jl.lstm_scan(jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0),
                                None if c0 is None else jnp.asarray(c0))
    yt, (ht, ct) = tl.lstm_scan(tp, torch.from_numpy(x),
                                None if h0 is None else torch.from_numpy(h0),
                                None if c0 is None else torch.from_numpy(c0))
    for got, want in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("jdt,tdt", [(jnp.bfloat16, torch.bfloat16), ("float16", "float16")])
def test_lstm_scan_float_cast_matches_jax(rng, jdt, tdt):
    """h and W_hh cast to a float type for the recurrent product, summed in
    fp32, on both sides. The products of the cast values are exact in fp32;
    only the summation order differs, which can move a later cast of h by one
    unit of its last place: 1e-2 absolute (h in [-1, 1])."""
    p = _lstm_params(rng, 6, 16)
    x = rng.standard_normal((2, 24, 6)).astype(np.float32)
    jp, tp = _both(p)
    yj, _ = jl.lstm_scan(jp, jnp.asarray(x), recurrent_dtype=jdt)
    yt, _ = tl.lstm_scan(tp, torch.from_numpy(x), recurrent_dtype=tdt)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-2)
    y32, _ = tl.lstm_scan(tp, torch.from_numpy(x))
    assert float((yt - y32).abs().max()) > 0  # the cast did change the numbers


def test_lstm_scan_int8_matches_jax(rng):
    """The int8 branch: per-row int8 W_hh, h at the fixed scale 127, exact
    integer sums on both sides; the fp32 input projection's round-off may
    move one quantized h by one code: 1e-2 absolute."""
    p = _lstm_params(rng, 6, 16)
    x = (0.5 * rng.standard_normal((2, 30, 6))).astype(np.float32)
    jp, tp = _both(p)
    yj, (hj, cj) = jl.lstm_scan(jp, jnp.asarray(x), recurrent_dtype="int8")
    yt, (ht, ct) = tl.lstm_scan(tp, torch.from_numpy(x), recurrent_dtype="int8")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-2)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-2)
    yq, _ = tl.lstm_scan(tp, torch.from_numpy(x), recurrent_dtype=torch.int8)
    assert torch.equal(yq, yt)


def test_lstm_int8_kernel_plain_version_matches_jax_kernel(rng):
    """``int8_kernel=True`` on the CPU runs the int8 branch, the plain
    version of JAX's int8-resident kernel, held to that kernel in interpret
    mode at the JAX suite's bar (1e-5 of scale, tests/test_pallas_lstm.py)."""
    p = _lstm_params(rng, 32, 128)
    x = (0.3 * rng.standard_normal((1, 12, 32))).astype(np.float32)
    jp, tp = _both(p)
    yj, (hj, cj) = jl.lstm_scan(jp, jnp.asarray(x), recurrent_dtype="int8", int8_kernel=True)
    yt, (ht, ct) = tl.lstm_scan(tp, torch.from_numpy(x), recurrent_dtype="int8",
                                int8_kernel=True)
    scale = float(np.abs(np.asarray(yj)).max())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5 * scale)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                               atol=1e-5 * max(float(np.abs(np.asarray(cj)).max()), 1.0))


def test_int8_routes_on_the_cpu_and_initial_state_match_jax(rng):
    """K10's route on CPU tensors: every ``int8_kernel`` runs the plain loop
    (the wrapper takes it for a CPU tensor, no launch), from zero and from a
    given state; against JAX's int8 scan from the same state at the int8
    branch's 1e-2 (one code of h may move by one)."""
    p = _lstm_params(rng, 6, 24)
    x = (0.5 * rng.standard_normal((3, 17, 6))).astype(np.float32)
    h0 = (0.4 * rng.standard_normal((3, 24))).astype(np.float32)
    c0 = rng.standard_normal((3, 24)).astype(np.float32)
    jp, tp = _both(p)
    xt, ht0, ct0 = map(torch.from_numpy, (x, h0, c0))
    before = k10.lstm_int8_recurrence.launches
    outs = [tl.lstm_scan(tp, xt, ht0, ct0, recurrent_dtype="int8", int8_kernel=k)
            for k in (None, False)]
    w_q, scale = tl.quantize_rows_int8(tp["w_hh"])
    xp = torch.matmul(xt, tp["w_ih"].T) + tp["b_ih"]
    direct = k10.lstm_int8_recurrence(xp, w_q, scale / 127.0, tp["b_hh"], ht0, ct0)
    assert k10.lstm_int8_recurrence.launches == before
    for y, (h, c) in outs + [direct]:
        assert torch.equal(y, outs[0][0]) and torch.equal(c, outs[0][1][1])
        assert torch.equal(h, y[:, -1])
    yj, (_, cj) = jl.lstm_scan(jp, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
                               recurrent_dtype="int8")
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(yj), atol=1e-2)
    np.testing.assert_allclose(outs[0][1][1].numpy(), np.asarray(cj), atol=1e-2)


def test_lstm_scan_refusals_match_jax(rng):
    p = _lstm_params(rng, 6, 8)
    x = rng.standard_normal((1, 4, 6)).astype(np.float32)
    jp, tp = _both(p)
    for jdt, tdt in ((jnp.int32, torch.int32), ("int16", "int16")):
        with pytest.raises(ValueError, match="integer recurrent_dtype"):
            jl.lstm_scan(jp, jnp.asarray(x), recurrent_dtype=jdt)
        with pytest.raises(ValueError, match="integer recurrent_dtype"):
            tl.lstm_scan(tp, torch.from_numpy(x), recurrent_dtype=tdt)
    # int8_kernel needs a 128-aligned width, as in JAX
    with pytest.raises(ValueError, match="128-aligned"):
        jl.lstm_scan(jp, jnp.asarray(x), recurrent_dtype="int8", int8_kernel=True)
    with pytest.raises(ValueError, match="128-aligned"):
        tl.lstm_scan(tp, torch.from_numpy(x), recurrent_dtype="int8", int8_kernel=True)


@pytest.mark.parametrize("b,t", [(2, 20), (1, 70)])
def test_complex_lstm_plain_matches_jax(rng, b, t):
    """The plain grouped scan vs JAX ``fused=False``: fp32 round-off, 1e-5."""
    params, r, im = _complex_case(rng, b, t, 12, 16)
    jp, tp = _both(params)
    want = jl.complex_lstm_scan(jp, jnp.asarray(r), jnp.asarray(im), fused=False)
    got = tl.complex_lstm_scan(tp, torch.from_numpy(r), torch.from_numpy(im))  # CPU: plain
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("b,t", [(1, 96), (4, 80)])
def test_k9_plain_version_matches_jax(rng, b, t):
    """K9's plain version (and the fused route on the CPU, which runs it)
    vs JAX: at fp32 round-off (1e-5) against ``fused=False``, and against
    JAX's kernel in interpret mode at JAX's own bar, 5e-3 of scale (the TPU
    kernel rounds h and W_hh to bf16)."""
    params, r, im = _complex_case(rng, b, t, 32, 32)
    jp, tp = _both(params)
    rj, ij = jnp.asarray(r), jnp.asarray(im)
    want = jl.complex_lstm_scan(jp, rj, ij, fused=False)
    want_k = jl.complex_lstm_scan(jp, rj, ij, fused=True)
    before = kl.grouped_lstm_recurrence.launches
    rt, it = torch.from_numpy(r), torch.from_numpy(im)
    with torch.no_grad():
        plain = kl.complex_lstm_scan_fused_plain(tp, rt, it)
        fused = tl.complex_lstm_scan(tp, rt, it, fused=True)
    assert kl.grouped_lstm_recurrence.launches == before  # a CPU tensor never launches
    scale = float(np.abs(np.asarray(want[0])).max())
    for p_, f_, w, wk in zip(plain, fused, want, want_k):
        assert torch.equal(p_, f_)
        np.testing.assert_allclose(p_.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(p_.numpy(), np.asarray(wk), atol=5e-3 * scale)


def test_k9_jax_kernel_layout(rng):
    """The port's grouped projection and recurrence give JAX's
    ``_grouped_lstm_fused_fwd`` ys (2, 2B, T, H), group-major rows."""
    params, r, im = _complex_case(rng, 2, 16, 8, 8)
    jp, tp = _both(params)
    stack = lambda k: jnp.stack([jp["real"][k], jp["imag"][k]])  # noqa: E731
    x2 = np.concatenate([r, im], 0)
    want = _grouped_lstm_fused_fwd(stack("w_ih"), stack("w_hh"), stack("b_ih"), stack("b_hh"),
                                   jnp.asarray(x2), interpret=True)
    xp = kl.grouped_projection(tp, torch.from_numpy(x2))
    got = kl.grouped_lstm_recurrence(xp, kl.stacked(tp, "w_hh"))
    assert tuple(got.shape) == (2, 4, 16, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)


def test_fused_gradients_equal_plain_scan(rng):
    """The Function's backward recomputes the plain grouped scan, so its
    gradients equal the plain route's: every leaf and both inputs to fp32
    round-off of the same computation (1e-6 of each leaf's scale)."""
    params, r, im = _complex_case(rng, 2, 40, 8, 12)
    grads = {}
    cot = [torch.from_numpy(rng.standard_normal((2, 40, 12)).astype(np.float32)) for _ in range(2)]
    for fused in (True, False):
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
        rt, it = torch.from_numpy(r).requires_grad_(), torch.from_numpy(im).requires_grad_()
        out = tl.complex_lstm_scan(tp, rt, it, fused=fused)
        leaves = [rt, it] + [tp[g][k] for g in ("real", "imag") for k in KEYS]
        grads[fused] = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), leaves)
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=1e-6 * max(float(b.abs().max()), 1e-9))


def test_fused_gradients_match_jax_custom_vjp(rng):
    """The port's fused-route gradients vs the gradients of JAX's plain
    scan (which its custom VJP recomputes): fp32 round-off, 1e-5 of scale."""
    params, r, im = _complex_case(rng, 1, 24, 8, 8)
    jp, _ = _both(params)

    def jloss(p, rr, ii):
        a, b = jl.complex_lstm_scan(p, rr, ii, fused=False)
        return jnp.sum(a * a) + jnp.sum(b * b)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(r), jnp.asarray(im))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    rt, it = torch.from_numpy(r).requires_grad_(), torch.from_numpy(im).requires_grad_()
    a, b = tl.complex_lstm_scan(tp, rt, it, fused=True)
    ((a * a).sum() + (b * b).sum()).backward()
    pairs = [(rt.grad, gj[1]), (it.grad, gj[2])] + [
        (tp[g][k].grad, gj[0][g][k]) for g in ("real", "imag") for k in KEYS]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * max(float(np.abs(want).max()), 1e-9))


def test_routing_on_the_cpu(rng):
    """fused=None on a CPU tensor is the plain loop (JAX's TPU-only route);
    a CUDA tensor would take K9 at B <= 16, T >= 64 (the card tests)."""
    params, r, im = _complex_case(rng, 1, 70, 8, 8)
    _, tp = _both(params)
    before = kl.grouped_lstm_recurrence.launches
    with torch.no_grad():
        a = tl.complex_lstm_scan(tp, torch.from_numpy(r), torch.from_numpy(im))
        b = tl.complex_lstm_scan(tp, torch.from_numpy(r), torch.from_numpy(im), fused=False)
    assert kl.grouped_lstm_recurrence.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- on-chip layouts of K10 and K9
# The H100's 132 SMs and 227 KB of shared memory a CTA; the small plans keep
# fewer chunks in registers and less shared memory, so that small nets still
# put codes (K10) or quads (K9) in all three places.
H100 = (132, 232448)


def _int8_plans(h, b):
    """K10 plans at H = h: the card's (everything in registers at these
    widths), two SMs without register codes (a shared / L2 split), and
    16 units a CTA with a quarter of the register chunks (registers, shared
    memory and L2 where H > 512), each with room for half its other chunks
    in shared memory."""
    plans = [k10.int8_plan(h, b, *H100)]
    for sms, quads in ((2, 0), (-(-h // 16), 4)):
        p0 = k10.int8_plan(h, b, sms, 0, quads)
        plans.append(k10.int8_plan(h, b, sms, p0.smem + p0.rs * 16 * max(1, p0.nrest // 2),
                                   quads))
    return plans


@pytest.mark.parametrize("h", [64, 100, 600, 1100])
def test_int8_layout_reassembles_the_codes(rng, h):
    """K10's layout holds every code of W_hh once: unpacked, it gives the
    codes back exactly, and its three parts (registers, shared memory, L2)
    together hold the CTA's rows."""
    w = rng.standard_normal((4 * h, h)).astype(np.float32)
    w_q, _ = tl.quantize_rows_int8(torch.from_numpy(w))
    seen = set()
    for plan in _int8_plans(h, 1):
        reg, rest = k10.pack_int8(w_q, plan, plan.rpw * plan.cr)
        assert tuple(rest.shape) == (plan.ctas, plan.rs, plan.nrest, 16)
        assert torch.equal(k10.unpack_int8(reg, rest, plan), w_q)
        assert plan.kreg + plan.nrest == plan.nk16 and 0 <= plan.ksm <= plan.nrest
        seen.add(tuple(v > 0 for v in plan.split().values()))
    if h > 512:
        assert (True, True, True) in seen  # registers, shared memory and L2 all used


@pytest.mark.parametrize("h,b", [(64, 1), (96, 3), (100, 1), (100, 3)])
def test_int8_layout_model_equals_plain_loop(rng, h, b):
    """The model of K10's dots from its layout (the register, shared and L2
    parts summed exactly) gives the plain int8 loop bit for bit, from a
    given state, at every plan."""
    p = _lstm_params(rng, 8, h)
    tp = _both(p)[1]
    w_q, scale = tl.quantize_rows_int8(tp["w_hh"])
    xp = torch.from_numpy(rng.standard_normal((b, 9, 4 * h)).astype(np.float32))
    h0 = torch.from_numpy((0.5 * rng.standard_normal((b, h))).astype(np.float32))
    c0 = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32))
    args = (scale / 127.0, tp["b_hh"], h0, c0)
    want, (hw, cw) = tl.lstm_int8_recurrence_plain(xp, w_q, *args)
    for plan in _int8_plans(h, b):
        quads = k10.REG_QUADS if plan.rpw == 0 else plan.rpw * plan.cr
        reg, rest = k10.pack_int8(w_q, plan, quads)
        got, (hg, cg) = k10.lstm_int8_recurrence_modeled(xp, reg, rest, plan, *args)
        assert torch.equal(got, want) and torch.equal(cg, cw) and torch.equal(hg, hw)


@pytest.mark.parametrize("b", [1, 3])
def test_int8_layout_model_matches_jax_kernel(rng, b):
    """The model of K10's layout against JAX's int8-resident kernel in
    interpret mode (which takes zero state and H % 128 == 0) at the JAX
    suite's bar, 1e-5 of scale."""
    h = 128
    p = _lstm_params(rng, 16, h)
    x = (0.3 * rng.standard_normal((b, 10, 16))).astype(np.float32)
    jp, tp = _both(p)
    w_q_j, scale_j = jl.quantize_rows_int8(jp["w_hh"])
    xp_j = jnp.asarray(x) @ jp["w_ih"].T + jp["b_ih"]
    ys_j, c_j = lstm_int8_fused(w_q_j.T, scale_j / 127.0, xp_j + jp["b_hh"], interpret=True)
    want, want_c = np.asarray(ys_j), np.asarray(c_j)
    w_q, scale = tl.quantize_rows_int8(tp["w_hh"])
    xp = torch.matmul(torch.from_numpy(x), tp["w_ih"].T) + tp["b_ih"]
    zeros = torch.zeros(b, h)
    for plan in _int8_plans(h, b):
        quads = k10.REG_QUADS if plan.rpw == 0 else plan.rpw * plan.cr
        reg, rest = k10.pack_int8(w_q, plan, quads)
        got, (_, c) = k10.lstm_int8_recurrence_modeled(xp, reg, rest, plan, scale / 127.0,
                                                       tp["b_hh"], zeros, zeros)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * float(np.abs(want).max()))
        np.testing.assert_allclose(c.numpy(), want_c,
                                   atol=1e-5 * max(float(np.abs(want_c).max()), 1.0))


def _grouped_plans(h, r):
    """K9 plans at H = h, R = r rows: the card's, and fewer SMs with fewer
    register quads and room for one position of shared quads (registers,
    shared memory and L2 all used where H > 256)."""
    plans = [kl.grouped_plan(2, r, h, *H100)]
    for sms, quads in ((20, 8), (10, 16)):
        p0 = kl.grouped_plan(2, r, h, sms, 0, quads)
        plans.append(kl.grouped_plan(2, r, h, sms, p0.smem + p0.cw * kl.THREADS * 16, quads))
    return plans


@pytest.mark.parametrize("h", [64, 96, 100, 300])
def test_grouped_layout_reassembles_w_hh(rng, h):
    """K9's layout holds every weight of both groups once: unpacked, it
    gives W_hh back exactly; the small plans use all three places."""
    w = torch.from_numpy(rng.standard_normal((2, 4 * h, h)).astype(np.float32))
    for i, plan in enumerate(_grouped_plans(h, 2)):
        packed = kl.pack_grouped(w, plan)
        assert tuple(packed.shape) == (plan.ctas, plan.npos * plan.cw, kl.THREADS, 4)
        assert torch.equal(kl.unpack_grouped(packed, plan), w)
        if i and h > 256:
            assert all(v > 0 for v in plan.split().values())


@pytest.mark.parametrize("h,b", [(64, 1), (96, 3), (100, 1), (300, 1)])
def test_grouped_layout_model_matches_plain_and_jax(rng, h, b):
    """The model of K9 from its layout, in the kernel's summation order
    (each lane's quads in k order, the warp's lanes as a tree), against
    the plain grouped recurrence at fp32 round-off (1e-5) and JAX's kernel
    in interpret mode at JAX's own bar, 5e-3 of scale (its TPU kernel
    rounds h and W_hh to bf16)."""
    params, r, im = _complex_case(rng, b, 12, 8, h)
    jp, tp = _both(params)
    stack = lambda k: jnp.stack([jp["real"][k], jp["imag"][k]])  # noqa: E731
    x2 = np.concatenate([r, im], 0)
    want_k = np.asarray(_grouped_lstm_fused_fwd(stack("w_ih"), stack("w_hh"), stack("b_ih"),
                                                stack("b_hh"), jnp.asarray(x2), interpret=True))
    xp = kl.grouped_projection(tp, torch.from_numpy(x2))
    w = kl.stacked(tp, "w_hh")
    want = tl.grouped_lstm_recurrence_plain(xp, w)
    scale = float(np.abs(want_k).max())
    for plan in _grouped_plans(h, 2 * b):
        got = kl.grouped_recurrence_modeled(xp, kl.pack_grouped(w, plan), plan)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_k, atol=5e-3 * scale)


def test_layouts_at_the_paths_shapes():
    """The plans the card takes on the paths (H100: 132 SMs, 227 KB a CTA):
    K10 at ATT-CCRN's H = 4096, B = 1 holds 128 KB of each CTA's 512 KB of
    codes in registers and 220 KB in shared memory, reading 164 KB from L2
    a step (21 MB over the grid, not the 67 MB); K9 at DCCRN's H = 1024
    holds all of W_hh on chip at B = 1 and, at B = 16, where h takes 128 KB,
    still 192 KB of each CTA's 256 KB."""
    p = k10.int8_plan(4096, 1, *H100)
    assert (p.units, p.ctas, p.rpw, p.kreg, p.ksm) == (32, 128, 8, 64, 110)
    assert p.split() == {"registers": 131072, "shared": 225280, "l2": 167936}
    assert p.smem <= H100[1]
    one = kl.grouped_plan(2, 2, 1024, *H100)
    assert (one.units, one.ctas, one.cw, one.npos, one.jreg, one.jsm) == (16, 128, 4, 8, 4, 4)
    assert one.split() == {"registers": 131072, "shared": 131072, "l2": 0}
    wide = kl.grouped_plan(2, 32, 1024, *H100)
    assert wide.split() == {"registers": 131072, "shared": 65536, "l2": 65536}
    assert wide.smem <= H100[1] and one.smem <= H100[1]
