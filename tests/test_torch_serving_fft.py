"""The FFT route of K3 and K4 (aec_tpu_torch.kernels.hop) modelled in plain
torch, against the plain versions and JAX's interpret-mode kernels."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.configs import KalmanConfig as JaxKalmanConfig
from aec_tpu.configs import NlmsConfig as JaxNlmsConfig
from aec_tpu.dsp.erb import erb_filterbank
from aec_tpu.dsp.stft import StftConfig as JaxStftConfig
from aec_tpu.kernels import pallas_serving as jsv
from aec_tpu.kernels.pallas_two_stage import two_stage_fused as jax_two_stage_fused
from aec_tpu.models.little_net import little_net_init
from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels import serving as tsv
from aec_tpu_torch.kernels import stage2 as tstage2
from aec_tpu_torch.kernels.two_stage import two_stage_fused_modeled, two_stage_fused_plain
from aec_tpu_torch.utils.weights import load_npz, params_from_jax

ROBUST = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "little_net_robust.npz")
S = 2


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _echo(rng, b, n, taps=200):
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (0.3 * np.exp(-np.arange(taps) / 50.0) * rng.standard_normal(taps)).astype(np.float32)
    near = 0.05 * rng.standard_normal((b, n))
    mic = np.stack([np.convolve(f, rir)[:n] for f in far]) + near
    return far, mic.astype(np.float32)


def _close(got, want, bar, what):
    scale = max(float(np.abs(want).max()), 1e-9)
    np.testing.assert_allclose(got, want, atol=bar * scale, rtol=0, err_msg=what)


# (filter, partitions, blocks per call) at the 160-sample hop, with
# normalize and gain_norm: against the plain version, and against JAX's
# interpret-mode kernel where ``jax`` (one compile each, ~6 s; the two cover
# both filters, both partition counts and both call lengths)
SERVING_CASES = [("kalman", 4, 1, False), ("kalman", 16, 3, True), ("nlms", 4, 1, True),
                 ("nlms", 4, 3, False), ("nlms", 16, 1, False), ("kalman", 16, 1, False)]


@pytest.mark.parametrize("stage1,n_blocks,k,with_jax", SERVING_CASES)
def test_serving_model_matches_plain_and_jax_kernel(rng, stage1, n_blocks, k, with_jax):
    """K3's FFT route modelled in torch (``serving_step_modeled``: fft_plan's
    transforms, the ring in the kernel's slots, a Kalman state predicted
    between hops) over 4 or 6 hops of 2 streams, against ``serving_step_plain``
    and, ``with_jax``, JAX's interpret-mode kernel at ``dot_mode="high"``:
    output blocks at 2e-4 of scale, every state leaf (through
    serving_state_to_stream) at 3e-4 of scale, 3e-3 for NLMS against JAX
    (the bars of tests/test_torch_serving.py)."""
    kw = {"normalize": True, "gain_norm": True, "stage1": stage1}
    hop = 160
    scfg, jscfg = StftConfig(2 * hop, hop, 2 * hop), JaxStftConfig(2 * hop, hop, 2 * hop)
    cfg, jcfg = ((KalmanConfig, JaxKalmanConfig) if stage1 == "kalman" else
                 (NlmsConfig, JaxNlmsConfig))
    kcfg, jkcfg = cfg(n_blocks=n_blocks), jcfg(n_blocks=n_blocks)
    erb = erb_filterbank(n_freqs=scfg.n_freqs)
    params = little_net_init(jax.random.PRNGKey(0))
    net = params_from_jax(params, device="cpu")
    hops = max(2 * k, 4)
    far, mic = _echo(rng, S, hops * hop)
    model, plain = (tsv.serving_init(S, kcfg=kcfg, scfg=scfg, stage1=stage1, device="cpu")
                    for _ in range(2))
    js = jsv.serving_init(S, tile=S, kcfg=jkcfg, scfg=jscfg, stage1=stage1) if with_jax else None
    outs = {"model": [], "plain": [], "jax": []}
    for lo in range(0, hops * hop, k * hop):
        fb, mb = far[:, lo:lo + k * hop], mic[:, lo:lo + k * hop]
        model, o = tsv.serving_step_modeled(net, model, torch.from_numpy(fb),
                                            torch.from_numpy(mb), erb, kcfg, scfg, **kw)
        outs["model"].append(o.numpy())
        plain, o = tsv.serving_step_plain(net, plain, torch.from_numpy(fb), torch.from_numpy(mb),
                                          erb, kcfg, scfg, **kw)
        outs["plain"].append(o.numpy())
        if with_jax:
            js, o = jsv.serving_step_fused(params, js, jnp.asarray(fb), jnp.asarray(mb),
                                           jnp.asarray(erb), jkcfg, jscfg, interpret=True,
                                           dot_mode="high", **kw)
            outs["jax"].append(np.asarray(o))
    got = np.concatenate(outs["model"], -1)
    refs = (("plain", 3e-4), ("jax", 3e-4 if stage1 == "kalman" else 3e-3))
    for ref, state_bar in refs[:1 + with_jax]:
        want = np.concatenate(outs[ref], -1)
        assert got.shape == want.shape == (S, hops * hop)
        for t in range(hops):
            blk = slice(t * hop, (t + 1) * hop)
            _close(got[:, blk], want[:, blk], 2e-4, f"out block {t} vs {ref}")
        leaves = _flat(tsv.serving_state_to_stream(model, stage1=stage1))
        want_leaves = _flat(jsv.serving_state_to_stream(js, stage1=stage1) if ref == "jax" else
                            tsv.serving_state_to_stream(plain, stage1=stage1))
        assert sorted(leaves) == sorted(want_leaves)
        for key, w in want_leaves.items():
            assert leaves[key].shape == w.shape, key
            _close(leaves[key], w, state_bar, f"{key} vs {ref}")
    np.testing.assert_allclose(model["nm"][:, 5:7].numpy(), plain["nm"][:, 5:7].numpy(),
                               rtol=3e-4, atol=1e-12)


@pytest.mark.parametrize("stage1", ["kalman", "nlms"])
def test_serving_model_matches_plain_at_the_default_geometry(rng, stage1):
    """The model at the default geometry (hop 256, L = 10: the plan the
    kernel compiles in), 3 calls of 2 hops for 3 streams with the robust
    checkpoint, against ``serving_step_plain`` at the same bars."""
    net = load_npz(ROBUST, device="cpu")
    erb = erb_filterbank()
    far, mic = _echo(rng, 3, 6 * 256)
    model, plain = (tsv.serving_init(3, stage1=stage1, device="cpu") for _ in range(2))
    for lo in range(0, 6 * 256, 2 * 256):
        fb, mb = torch.from_numpy(far[:, lo:lo + 512]), torch.from_numpy(mic[:, lo:lo + 512])
        model, om = tsv.serving_step_modeled(net, model, fb, mb, erb, stage1=stage1)
        plain, op = tsv.serving_step_plain(net, plain, fb, mb, erb, stage1=stage1)
        _close(om.numpy(), op.numpy(), 2e-4, "out")
    for key in tsv._KEYS:
        _close(model[key].numpy(), plain[key].numpy(), 3e-4, key)


# (hop, partitions, blocks, gain_norm)
TWO_STAGE_CASES = [(256, 10, 20, False), (160, 4, 24, True)]


@pytest.mark.parametrize("hop,n_blocks,t_blocks,gain_norm", TWO_STAGE_CASES)
def test_two_stage_model_matches_plain_and_jax_kernel(rng, hop, n_blocks, t_blocks, gain_norm):
    """K4's FFT route modelled in torch over a whole utterance (T hops from
    the initial state, then the zero flush frame), against the plain
    composition and JAX's interpret-mode kernel at ``dot_mode="high"``:
    wav, linear_wav and the T + 1 mask frames at 2e-3 of scale against JAX
    (tests/test_torch_two_stage.py's bar) and at 2e-4 against plain."""
    scfg, jscfg = StftConfig(2 * hop, hop, 2 * hop), JaxStftConfig(2 * hop, hop, 2 * hop)
    erb = erb_filterbank(n_freqs=scfg.n_freqs)
    params = little_net_init(jax.random.PRNGKey(5))
    net = params_from_jax(params, device="cpu")
    far, mic = _echo(np.random.default_rng(hop), 3, t_blocks * hop, taps=400)
    kw = {"kcfg": KalmanConfig(n_blocks=n_blocks), "scfg": scfg, "gain_norm": gain_norm}
    got = two_stage_fused_modeled(net, torch.from_numpy(far), torch.from_numpy(mic), erb, **kw)
    plain = two_stage_fused_plain(net, torch.from_numpy(far), torch.from_numpy(mic), erb, **kw)
    want = jax_two_stage_fused(params, jnp.asarray(far), jnp.asarray(mic), jnp.asarray(erb),
                               kcfg=JaxKalmanConfig(n_blocks=n_blocks), scfg=jscfg,
                               interpret=True, tile=3, dot_mode="high", gain_norm=gain_norm)
    assert got["mask"].shape == (3, t_blocks + 1, 32)
    for key in ("wav", "linear_wav", "mask"):
        assert got[key].shape == plain[key].shape == want[key].shape, key
        _close(got[key].numpy(), plain[key].numpy(), 2e-4, f"{key} vs plain")
        _close(got[key].numpy(), np.asarray(want[key]), 2e-3, f"{key} vs JAX")


@pytest.mark.parametrize("n_freqs,bands", [(257, 32), (161, 32), (257, 64)])
def test_erb_support_is_the_nonzero_ranges(n_freqs, bands):
    """The ERB support K2, K3 and K4 read: per band and per bin, the first and
    one past the last nonzero index; sums over those ranges equal the dense
    sums, and an empty row or column reads (n, 0)."""
    erb = erb_filterbank(n_freqs=n_freqs, n_bands=bands).astype(np.float32)
    erb[:, 3] = 0.0  # an empty band
    sup = tstage2.erb_support(torch.from_numpy(erb)).numpy()
    assert sup.dtype == np.int32 and sup.shape == (2 * (bands + n_freqs),)
    nz = erb != 0
    for e in range(bands):
        ks = np.flatnonzero(nz[:, e])
        assert (sup[e], sup[bands + e]) == ((ks[0], ks[-1] + 1) if ks.size else (n_freqs, 0))
    for k in range(n_freqs):
        es = np.flatnonzero(nz[k])
        lo, hi = sup[2 * bands + k], sup[2 * bands + n_freqs + k]
        assert (lo, hi) == ((es[0], es[-1] + 1) if es.size else (bands, 0))
    mag = np.abs(np.random.default_rng(0).standard_normal(n_freqs)).astype(np.float32)
    for e in range(bands):
        acc = np.float32(0)
        for k in range(sup[e], sup[bands + e]):
            acc = np.float32(acc + mag[k] * erb[k, e])
        dense = np.float32(0)
        for k in range(n_freqs):
            dense = np.float32(dense + mag[k] * erb[k, e])
        assert acc == dense


def test_cpu_wrappers_count_no_steps(rng):
    """On the CPU the wrappers take their plain versions and count no launch
    or step of either route."""
    from aec_tpu_torch.kernels.two_stage import two_stage_fused

    net = params_from_jax(little_net_init(jax.random.PRNGKey(0)), device="cpu")
    far, mic = _echo(rng, S, 4 * 256)
    counts = (dict(tsv.serving_step_fused.steps), dict(two_stage_fused.steps),
              tsv.serving_step_fused.launches, two_stage_fused.launches)
    tsv.serving_step_fused(net, tsv.serving_init(S, device="cpu"), torch.from_numpy(far),
                           torch.from_numpy(mic), erb_filterbank())
    two_stage_fused(net, torch.from_numpy(far), torch.from_numpy(mic), erb_filterbank())
    assert counts == (dict(tsv.serving_step_fused.steps), dict(two_stage_fused.steps),
                      tsv.serving_step_fused.launches, two_stage_fused.launches)


def test_erb_support_is_cached_until_the_matrix_changes():
    """The support is made once per ERB matrix: a second call returns the
    cached tensor; an in-place change to the matrix (its version moves)
    gives the new matrix's support."""
    erb = torch.from_numpy(erb_filterbank().astype(np.float32))
    first = tstage2.erb_support(erb)
    assert tstage2.erb_support(erb) is first
    erb[:, 0] = 0.0  # band 0 emptied in place
    again = tstage2.erb_support(erb)
    assert again is not first
    assert (int(again[0]), int(again[32])) == (erb.shape[0], 0)
    assert torch.equal(again[1:32], first[1:32])
