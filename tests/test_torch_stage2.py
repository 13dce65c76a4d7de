"""Port LittleNet stage 2 (aec_tpu_torch.models / kernels.stage2) == JAX."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.kernels.pallas_stage2 import little_net_apply_fused_wav as jax_fused_wav
from aec_tpu.models.little_net import little_net_apply as jax_apply
from aec_tpu.models.little_net import little_net_init
from aec_tpu.ops.gru import gru_scan as jax_gru_scan
from aec_tpu.train import checkpoints
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.dsp.stft import StftConfig
from aec_tpu_torch.kernels.stage2 import (
    frames_per_cta,
    little_net_apply_fused,
    little_net_apply_fused_plain,
    little_net_apply_fused_wav,
    little_net_apply_phased,
)
from aec_tpu_torch.models.little_net import little_net_apply
from aec_tpu_torch.ops.gru import gru_scan
from aec_tpu_torch.utils.weights import load_npz, params_from_jax

ROBUST = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "little_net_robust.npz")
HIGHEST = jax.lax.Precision.HIGHEST


def _inputs(rng, b=3, n=24 * 256):
    mic = rng.standard_normal((b, n)).astype(np.float32)
    ref = rng.standard_normal((b, n)).astype(np.float32)
    return mic, ref


def _jax_robust():
    return checkpoints.restore(ROBUST, {"params": little_net_init(jax.random.PRNGKey(0))})["params"]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("gain_norm", [False, True])
def test_little_net_apply_and_recurrence_match_jax(rng, normalize, gain_norm):
    """Shipped robust checkpoint through load_npz; offline apply and the K2
    plain recurrence vs JAX at Precision.HIGHEST (fp32)."""
    net = load_npz(ROBUST, device="cpu")
    erb = erb_filterbank()
    mic, ref = _inputs(rng)
    want = jax_apply(
        _jax_robust(), jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb),
        normalize=normalize, gain_norm=gain_norm, precision=HIGHEST,
    )
    want_wav, want_mask = np.asarray(want["wav"]), np.asarray(want["mask"])
    args = (torch.from_numpy(mic), torch.from_numpy(ref), torch.from_numpy(erb))
    with torch.no_grad():
        offline = little_net_apply(net, *args, normalize=normalize, gain_norm=gain_norm)
        frames = little_net_apply_fused_wav(net, *args, normalize=normalize, gain_norm=gain_norm)
    scale = max(float(np.abs(want_wav).max()), 1e-9)
    for got in (offline, frames):
        assert got["wav"].shape == want_wav.shape
        assert got["mask"].shape == want_mask.shape
        # fp32 round-off through STFT, GRU and pinv synthesis
        np.testing.assert_allclose(got["wav"].numpy(), want_wav, atol=1e-4 * scale)
        np.testing.assert_allclose(got["mask"].numpy(), want_mask, atol=1e-5)
    np.testing.assert_allclose(
        frames["wav"].numpy(), offline["wav"].numpy(), atol=1e-4 * scale
    )


@pytest.mark.parametrize("gain_norm", [False, True])
def test_recurrence_matches_jax_stage2_kernel(rng, gain_norm):
    """K2's plain version vs the TPU kernel it replaces (interpret mode,
    bf16_3x tier): the JAX suite's bar for that kernel (test_pallas_stage2.py:35)."""
    jp = little_net_init(jax.random.PRNGKey(3))
    net = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    erb = erb_filterbank()
    mic, ref = _inputs(rng, b=3, n=12 * 256)
    want = jax_fused_wav(
        jp, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb), normalize=False,
        interpret=True, tile=2, dot_mode="high", gain_norm=gain_norm,
    )
    with torch.no_grad():
        got = little_net_apply_fused_wav(
            net, torch.from_numpy(mic), torch.from_numpy(ref), torch.from_numpy(erb),
            normalize=False, gain_norm=gain_norm,
        )
    want_wav = np.asarray(want["wav"])
    scale = max(float(np.abs(want_wav).max()), 1e-9)
    np.testing.assert_allclose(got["wav"].numpy(), want_wav, atol=1e-3 * scale)
    np.testing.assert_allclose(got["mask"].numpy(), np.asarray(want["mask"]), atol=1e-3)


def test_random_net_mask_matches_jax(rng):
    """A random-init net keeps the mask away from sigmoid saturation."""
    jp = little_net_init(jax.random.PRNGKey(7))
    net = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    erb = erb_filterbank()
    mic, ref = _inputs(rng, b=2, n=16 * 256)
    want = jax_apply(jp, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb),
                     normalize=False, precision=HIGHEST)
    with torch.no_grad():
        got = little_net_apply(net, torch.from_numpy(mic), torch.from_numpy(ref),
                               torch.from_numpy(erb), normalize=False)
    want_mask = np.asarray(want["mask"])
    assert 0.05 < want_mask.mean() < 0.95
    np.testing.assert_allclose(got["mask"].numpy(), want_mask, atol=1e-5)
    np.testing.assert_allclose(got["est_erb"].numpy(), np.asarray(want["est_erb"]),
                               atol=1e-5 * np.abs(want["est_erb"]).max())


def test_per_utterance_norm_matches_jax(rng):
    jp = little_net_init(jax.random.PRNGKey(9))
    net = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    erb = erb_filterbank()
    mic, ref = _inputs(rng, b=2, n=8 * 256)
    mic[1] *= 5.0  # utterances of different level: per-utterance scalars differ
    want = np.asarray(jax_apply(jp, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb),
                                per_utt_norm=True, precision=HIGHEST)["wav"])
    with torch.no_grad():
        got = little_net_apply(net, torch.from_numpy(mic), torch.from_numpy(ref),
                               torch.from_numpy(erb), per_utt_norm=True)["wav"]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_gru_scan_matches_jax_and_torch_gru(rng):
    jp = little_net_init(jax.random.PRNGKey(1))
    net = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    want, _ = jax_gru_scan(jp["gru"], jnp.asarray(x))
    with torch.no_grad():
        got, h_last = gru_scan(net.gru_params(), torch.from_numpy(x))
        ref, _ = net.gru1(torch.from_numpy(x))  # torch.nn.GRU: same gate layout
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    assert torch.equal(h_last, got[:, -1])


def test_fused_wrapper_takes_plain_version_on_cpu(rng):
    net = load_npz(ROBUST, device="cpu")
    erb = torch.from_numpy(erb_filterbank())
    lin, far = (torch.from_numpy(a.reshape(2, -1, 256)) for a in _inputs(rng, b=2, n=6 * 256))
    before = little_net_apply_fused.launches
    with torch.no_grad():
        out, mask = little_net_apply_fused(net, lin, far, erb)
        want_out, want_mask = little_net_apply_fused_plain(net, lin, far, erb)
    assert out.shape == (2, 6, 256) and mask.shape == (2, 7, 32)
    assert torch.equal(out, want_out) and torch.equal(mask, want_mask)
    assert little_net_apply_fused.launches == before


def test_plain_version_evaluates_in_float64(rng):
    """The plain version computes in its inputs' dtype: a float64 net and
    blocks give the fp64 evaluation the card's round-off checks hold K2
    against. It is the same function: the fp32 JAX apply (Precision.HIGHEST)
    of an untrained net on the same inputs agrees to the mask bar, 1e-5, and
    the wav to 1e-4 of scale."""
    import copy

    jp = little_net_init(jax.random.PRNGKey(7))
    net = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    erb = erb_filterbank()
    mic, ref = _inputs(rng, b=2, n=16 * 256)
    want = jax_apply(jp, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb),
                     normalize=False, precision=HIGHEST)
    with torch.no_grad():
        got = little_net_apply_fused_wav(
            copy.deepcopy(net).double(), torch.from_numpy(mic).double(),
            torch.from_numpy(ref).double(), torch.from_numpy(erb).double(), normalize=False,
        )
    assert got["wav"].dtype == got["mask"].dtype == torch.float64
    want_wav = np.asarray(want["wav"])
    np.testing.assert_allclose(got["mask"].numpy(), np.asarray(want["mask"]), atol=1e-5)
    np.testing.assert_allclose(got["wav"].numpy(), want_wav, atol=1e-4 * np.abs(want_wav).max())


# ---------------------------------------------------------------- K2's three phases


def _net_pair(seed, bands=32):
    """An untrained JAX LittleNet of ``bands`` ERB bands and the same net in torch."""
    jp = little_net_init(jax.random.PRNGKey(seed), erb_bands=bands)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _phased(net, mic, ref, erb, cfg, run, gain_norm):
    """The phase model on (B, n) waveforms cut into blocks -> (wav, mask) numpy."""
    def blocks(a):
        return torch.from_numpy(a).reshape(a.shape[0], -1, cfg.hop)

    with torch.no_grad():
        out, mask = little_net_apply_phased(net, blocks(mic), blocks(ref), torch.from_numpy(erb),
                                            cfg, gain_norm=gain_norm, run=run)
    return out.reshape(out.shape[0], -1).numpy(), mask.numpy()


# (hop, bands, blocks, frames per run): seams at odd places (runs of 3 over
# 13 frames, of 5 over 10, of 4 over 10), every frame a seam (runs of 1),
# Tb = 1 (the first and the flush frame only), E = 64, the 160-sample hop
PHASE_CASES = [(256, 32, 12, 3), (256, 32, 1, 8), (256, 64, 9, 5), (160, 32, 10, 1),
               (160, 32, 9, 4)]


@pytest.mark.parametrize("gain_norm", [False, True])
@pytest.mark.parametrize("hop,bands,t_blocks,run", PHASE_CASES)
def test_phase_model_matches_plain_version(rng, hop, bands, t_blocks, run, gain_norm):
    """K2's three-phase formulation (FFT analysis per run of frames, the
    recurrence over all frames, FFT synthesis per run with the frame before
    the run recomputed for its tail) against its plain per-frame version:
    wav within 1e-4 of scale, mask within 1e-5, the kernel's bars."""
    cfg = StftConfig(2 * hop, hop, 2 * hop)
    _, net = _net_pair(5, bands)
    erb = erb_filterbank(n_freqs=cfg.n_freqs, n_bands=bands)
    mic, ref = _inputs(rng, b=2, n=t_blocks * hop)
    got_wav, got_mask = _phased(net, mic, ref, erb, cfg, run, gain_norm)
    with torch.no_grad():
        want = little_net_apply_fused_wav(net, torch.from_numpy(mic), torch.from_numpy(ref),
                                          torch.from_numpy(erb), cfg, normalize=False,
                                          gain_norm=gain_norm)
    want_wav = want["wav"].numpy()
    assert got_wav.shape == want_wav.shape and got_mask.shape == (2, t_blocks + 1, bands)
    np.testing.assert_allclose(got_wav, want_wav, atol=1e-4 * np.abs(want_wav).max())
    np.testing.assert_allclose(got_mask, want["mask"].numpy(), atol=1e-5)


@pytest.mark.parametrize("gain_norm", [False, True])
@pytest.mark.parametrize("bands", [32, 64])
def test_phase_model_matches_jax_offline_apply(rng, bands, gain_norm):
    """The three-phase formulation (runs of 3 over 13 frames) against JAX's
    offline little_net_apply at Precision.HIGHEST: wav within 1e-4 of
    scale, mask within 1e-5."""
    jp, net = _net_pair(11, bands)
    erb = erb_filterbank(n_bands=bands)
    mic, ref = _inputs(rng, b=2, n=12 * 256)
    want = jax_apply(jp, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb), normalize=False,
                     gain_norm=gain_norm, precision=HIGHEST)
    got_wav, got_mask = _phased(net, mic, ref, erb, StftConfig(), 3, gain_norm)
    want_wav = np.asarray(want["wav"])
    assert got_wav.shape == want_wav.shape
    np.testing.assert_allclose(got_wav, want_wav, atol=1e-4 * np.abs(want_wav).max())
    np.testing.assert_allclose(got_mask, np.asarray(want["mask"]), atol=1e-5)


@pytest.mark.parametrize("gain_norm", [False, True])
def test_phase_model_matches_jax_stage2_kernel(rng, gain_norm):
    """The three-phase formulation (runs of 5 over 13 frames) against the
    TPU kernel K2 replaces, in interpret mode at dot_mode="high": the bars
    of test_recurrence_matches_jax_stage2_kernel."""
    jp, net = _net_pair(3)
    erb = erb_filterbank()
    mic, ref = _inputs(rng, b=3, n=12 * 256)
    want = jax_fused_wav(
        jp, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb), normalize=False,
        interpret=True, tile=2, dot_mode="high", gain_norm=gain_norm,
    )
    got_wav, got_mask = _phased(net, mic, ref, erb, StftConfig(), 5, gain_norm)
    want_wav = np.asarray(want["wav"])
    np.testing.assert_allclose(got_wav, want_wav, atol=1e-3 * np.abs(want_wav).max())
    np.testing.assert_allclose(got_mask, np.asarray(want["mask"]), atol=1e-3)


@pytest.mark.parametrize("batch,frames,run", [(256, 513, 8), (4, 513, 8), (2, 513, 4),
                                              (1, 513, 2), (1, 1001, 4), (1, 1, 1)])
def test_frames_per_cta_fills_the_card(batch, frames, run):
    """Runs of 8 frames per CTA of phases A and C while that leaves a CTA
    for every SM of a 132-SM card, halved until it does, down to 1; and
    halved until a run's layout fits a CTA's shared memory (a long hop)."""
    assert frames_per_cta(batch, frames, 132) == run
    assert frames_per_cta(batch, frames, 132, lambda r: r <= 2) == min(run, 2)
    assert frames_per_cta(batch, frames, 132, lambda r: False) == 1
