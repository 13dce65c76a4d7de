"""Port DSP front end (aec_tpu_torch.dsp) == the JAX package's (aec_tpu.dsp)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.dsp import erb as jerb
from aec_tpu.dsp import stft as jstft
from aec_tpu.dsp import windows as jwin
from aec_tpu_torch.dsp import erb as terb
from aec_tpu_torch.dsp import stft as tstft
from aec_tpu_torch.dsp import windows as twin


@pytest.mark.parametrize("win_type", ["hann", "hamming", "blackman", None])
def test_periodic_window_byte_equal(win_type):
    # both are float64 numpy builders: byte-equal
    want = jwin.periodic_window(win_type, 512)
    got = twin.periodic_window(win_type, 512)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("perfect", [False, True])
def test_erb_filterbank_byte_equal(perfect):
    for dtype in (np.float32, np.float64):
        want = jerb.erb_filterbank(perfect=perfect, dtype=dtype)
        got = terb.erb_filterbank(perfect=perfect, dtype=dtype)
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_stft_bases_byte_equal():
    a_j, s_j = jstft._bases(jstft.StftConfig())
    a_t, s_t = tstft._bases(tstft.StftConfig())
    assert a_t.tobytes() == a_j.tobytes()
    assert s_t.tobytes() == s_j.tobytes()


def test_stft_istft_match_jax(rng):
    cfg_j, cfg_t = jstft.StftConfig(), tstft.StftConfig()
    x = rng.standard_normal((3, 4096)).astype(np.float32)
    spec_j = np.array(jstft.stft(jnp.asarray(x), cfg_j))  # writable: torch.from_numpy below
    spec_t = tstft.stft(torch.from_numpy(x), cfg_t).numpy()
    assert spec_t.shape == spec_j.shape == (3, 4096 // 256 + 1, 514)
    # fp32 round-off of one 512-long dot product per bin
    scale = np.abs(spec_j).max()
    np.testing.assert_allclose(spec_t, spec_j, atol=1e-5 * scale)

    wav_j = np.asarray(jstft.istft(jnp.asarray(spec_j), cfg_j))
    wav_t = tstft.istft(torch.from_numpy(spec_j), cfg_t).numpy()
    assert wav_t.shape == x.shape
    np.testing.assert_allclose(wav_t, wav_j, atol=1e-5 * np.abs(x).max())
    # the pinv synthesis inverts the analysis
    np.testing.assert_allclose(wav_t, x, atol=1e-5 * np.abs(x).max())


def test_framing_and_overlap_add_match_jax(rng):
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    frames_j = np.array(jstft.frame_signal(jnp.asarray(x), 512, 256))
    frames_t = tstft.frame_signal(torch.from_numpy(x), 512, 256).numpy()
    np.testing.assert_array_equal(frames_t, frames_j)
    np.testing.assert_allclose(
        tstft.overlap_add(torch.from_numpy(frames_j), 256).numpy(),
        np.asarray(jstft.overlap_add(jnp.asarray(frames_j), 256)),
        rtol=1e-6, atol=1e-6,
    )
    env_j = np.asarray(jstft.ola_envelope(9, jstft.StftConfig()))
    env_t = tstft.ola_envelope(9, tstft.StftConfig()).numpy()
    np.testing.assert_array_equal(env_t, env_j)


def test_magnitude_matches_jax(rng):
    spec = rng.standard_normal((4, 7, 514)).astype(np.float32)
    np.testing.assert_allclose(
        tstft.magnitude(torch.from_numpy(spec)).numpy(),
        np.asarray(jstft.magnitude(jnp.asarray(spec))),
        rtol=1e-6,
    )
