"""Port FullSubNet (aec_tpu_torch.dsp.mel, models.fullsubnet, kernels.fullsubnet: K11's
route) == JAX, on the same numpy inputs and JAX's weights carried over.

K11's plain version is held to JAX's joint kernel in interpret mode, as the
JAX suite runs it (tests/test_fullsubnet.py), and to JAX's joint scan."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.dsp.mel import mel_filterbank as jax_mel
from aec_tpu.kernels.pallas_fullsubnet import fsn_joint_fused as jax_fsn_joint_fused
from aec_tpu.models import fullsubnet as jf
from aec_tpu.train.generic import make_adapter as jax_make_adapter
from aec_tpu_torch.dsp.mel import mel_filterbank
from aec_tpu_torch.kernels import fullsubnet as kf
from aec_tpu_torch.models import fullsubnet as tf
from aec_tpu_torch.train.generic import make_adapter
from aec_tpu_torch.utils.weights import fullsubnet_from_jax, fullsubnet_to_jax

SMALL = dict(fb_hidden=32, sb_hidden=16)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: {err:.3e} > {atol:.3e}"


def _mags(rng, b, t, f):
    return tuple(np.abs(rng.standard_normal((b, t, f))).astype(np.float32) for _ in range(2))


def _projections(rng, cfg, b, t):
    f = cfg.n_freqs
    xp_fb = (0.3 * rng.standard_normal((b, t, 4 * cfg.fb_hidden))).astype(np.float32)
    xp_sb = (0.3 * rng.standard_normal((b, t, f, 4 * cfg.sb_hidden))).astype(np.float32)
    return xp_fb, xp_sb


def test_mel_filterbank_matches_jax():
    """numpy on both sides: the same bank to the last bit, at the reference's
    defaults and another size."""
    for kw in ({}, dict(nfilt=40, nfft=512)):
        np.testing.assert_array_equal(mel_filterbank(**kw), jax_mel(**kw))
    assert mel_filterbank().shape == (161, 21) and mel_filterbank().dtype == np.float32


@pytest.mark.parametrize("use_mel", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_masks_match_jax(rng, use_mel, fused):
    """Both forms against JAX's, at the JAX suite's own bar between them
    (2e-6, tests/test_fullsubnet.py:100-102): fp32 round-off of the same
    sums in other orders."""
    cfg_j = jf.FullSubNetConfig(neighborhood=3, use_mel=use_mel, **SMALL)
    cfg_t = tf.FullSubNetConfig(neighborhood=3, use_mel=use_mel, **SMALL)
    params = jf.fullsubnet_init(jax.random.PRNGKey(2), cfg_j)
    mic, ref = _mags(rng, 2, 23, cfg_t.n_freqs)
    want = jf.fullsubnet_masks(params, jnp.asarray(mic), jnp.asarray(ref), cfg_j, fused=fused)
    with torch.no_grad():
        got = tf.fullsubnet_masks(_t(params), torch.from_numpy(mic), torch.from_numpy(ref),
                                  cfg_t, fused=fused)
    for g, w, what in zip(got, want, ("near", "echo")):
        _close(g, w, 2e-6, what)


def test_k11_plain_version_matches_jax(rng):
    """K11's plain version (and the fused route on the CPU, which runs it):
    against JAX's joint scan at fp32 round-off (1e-5; h in [-1, 1]), and
    against JAX's joint kernel in interpret mode at JAX's own bar, 5e-3 of
    scale (the TPU kernel rounds the dots' operands to bf16)."""
    cfg = jf.FullSubNetConfig(**SMALL)
    params = jf.fullsubnet_init(jax.random.PRNGKey(1), cfg)
    xp_fb, xp_sb = _projections(rng, cfg, 1, 24)
    want = jf._joint_scan_hs(params, jnp.asarray(xp_fb), jnp.asarray(xp_sb))
    want_k = jax_fsn_joint_fused(params, jnp.asarray(xp_fb[0]), jnp.asarray(xp_sb[0]), True)
    tp = _t(params)
    before = kf.joint_recurrence.launches
    with torch.no_grad():
        plain = tf._joint_scan_hs(tp, torch.from_numpy(xp_fb), torch.from_numpy(xp_sb))
        routed = kf.fsn_joint_fused(tp, torch.from_numpy(xp_fb), torch.from_numpy(xp_sb))
    assert kf.joint_recurrence.launches == before  # a CPU tensor never launches
    assert torch.equal(plain, routed) and tuple(plain.shape) == (1, 24, 161, 16)
    _close(plain, want, 1e-5, "vs joint scan")
    scale = float(np.abs(np.asarray(want)).max())
    _close(plain[0], want_k, 5e-3 * scale, "vs interpret-mode kernel")


def test_k11_gradients_match_jax(rng):
    """The Function's backward recomputes the plain joint loop: its
    gradients (both projections and every weight the recurrence reads) vs
    jax.grad of the same loss through JAX's joint scan, 1e-5 of each leaf's
    scale (fp32 round-off of the same computation)."""
    cfg = jf.FullSubNetConfig(**SMALL)
    params = jf.fullsubnet_init(jax.random.PRNGKey(3), cfg)
    xp_fb, xp_sb = _projections(rng, cfg, 2, 12)

    def jloss(p, a, b):
        h = jf._joint_scan_hs(p, a, b)
        return jnp.sum(h * h)

    gp, ga, gb = jax.grad(jloss, argnums=(0, 1, 2))(params, jnp.asarray(xp_fb),
                                                   jnp.asarray(xp_sb))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    a, b = (torch.from_numpy(v).requires_grad_() for v in (xp_fb, xp_sb))
    h = kf.fsn_joint_fused(tp, a, b)
    (h * h).sum().backward()
    pairs = [(a.grad, ga, "xp_fb"), (b.grad, gb, "xp_sb")] + [
        (tp[x][y].grad, gp[x][y], f"{x}.{y}") for x, y in kf._LEAVES]
    for got, want, what in pairs:
        _close(got, want, 1e-5 * max(float(np.abs(np.asarray(want)).max()), 1e-9), what)


def test_apply_and_loss_match_jax(rng):
    """``fullsubnet_apply`` (both wavs, both masks, the spectrum) and
    ``fullsubnet_loss`` on JAX's weights: fp32 round-off through STFT, two
    LSTMs and iSTFT, 1e-5 of each output's scale; the weights round trip
    through the module bit for bit."""
    cfg_j, cfg_t = jf.FullSubNetConfig(**SMALL), tf.FullSubNetConfig(**SMALL)
    params = jf.fullsubnet_init(jax.random.PRNGKey(0), cfg_j)
    net = fullsubnet_from_jax(params, cfg_t, device="cpu")
    for x, y in zip(jax.tree_util.tree_leaves(fullsubnet_to_jax(net)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(x, np.asarray(y))
    mic, ref, near, echo = (rng.standard_normal((2, 3200)).astype(np.float32)
                            for _ in range(4))
    want = jf.fullsubnet_apply(params, jnp.asarray(mic), jnp.asarray(ref), cfg_j)
    with torch.no_grad():
        got = net(torch.from_numpy(mic), torch.from_numpy(ref))
    for k in ("wav", "echo_wav", "mask_near", "mask_echo", "out_spec"):
        _close(got[k], want[k], 1e-5 * float(np.abs(np.asarray(want[k])).max()), k)
    lj, _ = jf.fullsubnet_loss(params, *map(jnp.asarray, (mic, ref, near, echo)), cfg_j)
    lt, _ = tf.fullsubnet_loss(net.params(), *map(torch.from_numpy, (mic, ref, near, echo)),
                               cfg_t)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)


def test_adapter_and_init_match_jax(rng):
    """The adapter's enhance at ``FullSubNetConfig()`` widths on JAX's
    weights (1e-5 of scale; the loss is held at narrow widths above); the
    port's init draws the JAX tree's shapes within torch's bounds; the
    configs' fields agree."""
    ja, ta = jax_make_adapter("fullsubnet"), make_adapter("fullsubnet")
    params, _ = ja.init(jax.random.PRNGKey(4))
    fresh, state = ta.init(generator=torch.Generator().manual_seed(0), device="cpu")
    assert state == {} and not ta.stateful
    assert jax.tree.map(lambda v: tuple(v.shape), fresh) == jax.tree.map(np.shape, params)
    assert float(fresh["fb_out"]["w"].abs().max()) <= 1 / 16 and not fresh["sb_out"]["b"].any()
    assert tf.FullSubNetConfig() == tf.FullSubNetConfig(
        **{k: getattr(jf.FullSubNetConfig(), k) for k in ("fb_hidden", "sb_hidden",
                                                          "neighborhood", "use_mel",
                                                          "mel_filters")})
    mic, far = (rng.standard_normal((1, 1600)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        wt = ta.enhance(_t(params), {}, torch.from_numpy(mic), torch.from_numpy(far))
    wj = ja.enhance(params, {}, jnp.asarray(mic), jnp.asarray(far))
    _close(wt, wj, 1e-5 * float(np.abs(np.asarray(wj)).max()), "enhance")


@pytest.mark.parametrize("b", [1, 3])
def test_split_order_matches_jax(rng, b):
    """K11's order of work (kernels.fullsubnet.joint_recurrence_split: the
    full band and the embedding over all frames, then the sub-band rows)
    against JAX's joint scan and the port's frame-by-frame loop: the same
    sums per row in the same order, so fp32 round-off, 1e-5 absolute (h in
    [-1, 1]). This is the independence of the sub band from the full band's
    later frames that the kernel's producer / consumer design rests on."""
    cfg = jf.FullSubNetConfig(fb_hidden=24, sb_hidden=8)
    params = jf.fullsubnet_init(jax.random.PRNGKey(5), cfg)
    xp_fb, xp_sb = _projections(rng, cfg, b, 17)
    want = jf._joint_scan_hs(params, jnp.asarray(xp_fb), jnp.asarray(xp_sb))
    tp = _t(params)
    with torch.no_grad():
        got = kf.joint_recurrence_split(tp, torch.from_numpy(xp_fb), torch.from_numpy(xp_sb))
        plain = tf._joint_scan_hs(tp, torch.from_numpy(xp_fb), torch.from_numpy(xp_sb))
    assert tuple(got.shape) == (b, 17, 161, 8)
    _close(got, want, 1e-5, "vs JAX's joint scan")
    _close(got, plain.numpy(), 1e-5, "vs the port's joint loop")


def _old_plan_smem(b, f, hf, hs, sms=132):
    """The shared memory of one CTA of K11's first design (fsn_plan and
    fsn_smem_floats of its fullsubnet.cu): min(B F, SMs) CTAs, each with the
    whole sub-band W_hh^T, its full-band units' gate rows, its rows of W_out,
    every utterance's h_fb, and its rows' state."""
    ctas = min(b * f, sms)
    rmax, umax = -(-b * f // ctas), -(-hf // ctas)
    return 4 * (hs * 4 * hs + 4 * umax * hf + rmax * hf + b * hf + b * umax + 2 * rmax * hs
                + rmax * 4 * hs + 4 * hs + 2 * rmax)


def test_plan_takes_every_shape_the_first_design_took():
    """kernels.fullsubnet.fsn_plan (the launch plan csrc/fullsubnet.cu makes)
    at 227 KB a CTA and 15 clusters of 8 (what a 132-SM H100 places): every (B, H_fb,
    H_sb) at F = 161 that the first design's plan fit at 132 SMs fits, and
    more (B = 16 at FullSubNetConfig()'s widths). The producer holds
    FullSubNetConfig()'s W_hh_fb in registers and nothing from L2; at H_fb =
    512 the rest of it is read from L2. B = 64 at 256 / 96 does not fit (the
    card test's refusal)."""
    cap = 232448
    for hs in (16, 96, 112):
        for hf in (32, 256, 512):
            for b in (1, 4, 16):
                plan = kf.fsn_plan(b, 161, hf, hs, smem_cap=cap)
                if _old_plan_smem(b, 161, hf, hs) <= cap:
                    assert plan["smem"] <= cap, (b, hf, hs, plan)
                assert plan["depth"] >= 2 and plan["clusters"] == 15
                assert plan["consumers"] * plan["rows"] >= b * 161
                assert plan["sp"] * plan["up"] <= kf.THREADS
                assert plan["sc"] * hs <= kf.THREADS
    assert _old_plan_smem(16, 161, 256, 96) > cap >= kf.fsn_plan(16, 161, 256, 96)["smem"]
    default = kf.fsn_plan(1, 161, 256, 96)
    assert (default["rows"], default["np"], default["jrp"], default["l2_bytes"]) == (2, 4, 4, 0)
    assert (default["sc"], default["nc"], default["jrc"], default["jsc"]) == (4, 6, 4, 2)
    wide = kf.fsn_plan(1, 161, 512, 96)
    assert wide["jsp"] > 0 and wide["l2_bytes"] > 0 and wide["smem"] <= cap
    assert kf.fsn_plan(64, 161, 256, 96)["smem"] > cap
    with pytest.raises(ValueError, match="units"):
        kf.fsn_plan(1, 161, 256, 600)


def test_plan_uses_the_clusters_it_is_given():
    """Fewer clusters on the card -> more rows a consumer CTA; as few
    consumer clusters as the rows need; two clusters at least."""
    assert kf.fsn_plan(1, 161, 256, 96, clusters=4)["rows"] == 7
    small = kf.fsn_plan(1, 20, 32, 16)
    assert (small["clusters"], small["consumers"], small["rows"]) == (4, 24, 1)
    with pytest.raises(ValueError, match="two clusters"):
        kf.fsn_plan(1, 161, 256, 96, clusters=1)
