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
from aec_tpu_torch.kernels.stage2 import (
    little_net_apply_fused,
    little_net_apply_fused_plain,
    little_net_apply_fused_wav,
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
    net = load_npz(ROBUST)
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
    net = params_from_jax(jax.tree.map(np.asarray, jp))
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
    net = params_from_jax(jax.tree.map(np.asarray, jp))
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
    net = params_from_jax(jax.tree.map(np.asarray, jp))
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
    net = params_from_jax(jax.tree.map(np.asarray, jp))
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    want, _ = jax_gru_scan(jp["gru"], jnp.asarray(x))
    with torch.no_grad():
        got, h_last = gru_scan(net.gru_params(), torch.from_numpy(x))
        ref, _ = net.gru1(torch.from_numpy(x))  # torch.nn.GRU: same gate layout
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    assert torch.equal(h_last, got[:, -1])


def test_fused_wrapper_takes_plain_version_on_cpu(rng):
    net = load_npz(ROBUST)
    erb = torch.from_numpy(erb_filterbank())
    lin, far = (torch.from_numpy(a.reshape(2, -1, 256)) for a in _inputs(rng, b=2, n=6 * 256))
    before = little_net_apply_fused.launches
    with torch.no_grad():
        out, mask = little_net_apply_fused(net, lin, far, erb)
        want_out, want_mask = little_net_apply_fused_plain(net, lin, far, erb)
    assert out.shape == (2, 6, 256) and mask.shape == (2, 7, 32)
    assert torch.equal(out, want_out) and torch.equal(mask, want_mask)
    assert little_net_apply_fused.launches == before

