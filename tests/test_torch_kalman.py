"""Port Kalman stage 1 (aec_tpu_torch.linear / kernels.kalman) == JAX."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.configs import KalmanConfig as JaxKalmanConfig
from aec_tpu.kernels.pallas_kalman import kalman_cancel_fused as jax_kalman_cancel_fused
from aec_tpu.kernels.pallas_kalman import kalman_cancel_fused_batched_bl
from aec_tpu.linear import overlap_save as jols
from aec_tpu.linear.kalman import kalman_cancel as jax_kalman_cancel
from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.kernels.kalman import kalman_cancel_fused, kalman_cancel_fused_batched
from aec_tpu_torch.linear import overlap_save as tols
from aec_tpu_torch.linear.kalman import kalman_cancel, kalman_cancel_plain


def _scene(rng, b=5, n=16 * 256):
    """As tests/test_pallas_kalman.py: odd batch, a 300-tap decaying RIR."""
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (np.exp(-np.arange(300) / 60.0) * rng.standard_normal(300)).astype(np.float32)
    mic = np.stack([np.convolve(far[i], 0.4 * rir)[:n] for i in range(b)]).astype(np.float32)
    return far, mic


def test_config_restates_jax_config():
    assert dataclasses.asdict(KalmanConfig()) == dataclasses.asdict(JaxKalmanConfig())


def test_dft_mats_byte_equal():
    for got, want in zip(tols._dft_mats(256), jols._dft_mats(256)):
        assert got.tobytes() == want.tobytes()


def test_far_end_spectra_match_jax(rng):
    far = rng.standard_normal((2, 8 * 256)).astype(np.float32)
    want = np.asarray(jols.far_end_spectra(jnp.asarray(far), 256))
    got = tols.far_end_spectra(torch.from_numpy(far), 256).numpy()
    assert got.shape == want.shape == (2, 8, 514)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_kalman_cancel_matches_jax_scan(rng):
    cfg = KalmanConfig()
    far, mic = _scene(rng)
    out_j = jax_kalman_cancel(JaxKalmanConfig(), jnp.asarray(far), jnp.asarray(mic), fused=False)
    out_t = kalman_cancel(cfg, torch.from_numpy(far), torch.from_numpy(mic))
    want, got = np.asarray(out_j["wav"]), out_t["wav"].numpy()
    assert got.shape == want.shape
    # the JAX suite's own bar for kernel vs scan (test_pallas_kalman.py:125)
    scale = max(float(np.abs(want).max()), 1e-9)
    np.testing.assert_allclose(got, want, atol=2e-4 * scale)
    # the final filter state agrees too (the JAX scan is vmapped: [B, ...])
    w_j = np.asarray(out_j["state"]["w"])
    np.testing.assert_allclose(out_t["state"]["w"].numpy(), w_j, atol=2e-4 * np.abs(w_j).max())
    np.testing.assert_allclose(
        out_t["state"]["psi"].numpy(), np.asarray(out_j["state"]["psi"]), rtol=2e-3, atol=1e-9
    )


def test_kalman_matches_jax_batched_kernel(rng):
    """Same block bookkeeping as the TPU kernel K1 replaces (interpret mode,
    the JAX suite's exact-numerics tier)."""
    cfg = KalmanConfig()
    far, mic = _scene(rng)
    want = np.asarray(
        kalman_cancel_fused_batched_bl(
            JaxKalmanConfig(), jnp.asarray(far), jnp.asarray(mic), interpret=True, tile=2,
            dot_mode="high",
        )["wav"]
    )
    got = kalman_cancel_fused_batched(cfg, torch.from_numpy(far), torch.from_numpy(mic))["wav"]
    scale = max(float(np.abs(want).max()), 1e-9)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * scale)


def test_single_stream_matches_jax_kernel(rng):
    """A 1-D input through the single-stream wrapper (the plain loop on the
    CPU) vs the TPU kernel K6 replaces, in interpret mode at "high", on a
    hop-fractional length; 2e-4 of scale, the JAX suite's bar."""
    far, mic = _scene(rng, b=1, n=20 * 256 + 77)
    want = np.asarray(
        jax_kalman_cancel_fused(JaxKalmanConfig(), jnp.asarray(far[0]), jnp.asarray(mic[0]),
                                interpret=True, dot_mode="high")["wav"]
    )
    before = kalman_cancel_fused.launches
    got = kalman_cancel_fused(KalmanConfig(), torch.from_numpy(far[0]), torch.from_numpy(mic[0]))
    assert kalman_cancel_fused.launches == before
    assert got["wav"].shape == want.shape == (20 * 256 + 77,)
    np.testing.assert_allclose(got["wav"].numpy(), want, atol=2e-4 * np.abs(want).max())


def test_wrapper_takes_plain_version_on_cpu(rng):
    cfg = KalmanConfig()
    far, mic = _scene(rng, b=2, n=6 * 256 + 17)  # hop-fractional length: padded
    before = kalman_cancel_fused_batched.launches
    got = kalman_cancel_fused_batched(cfg, torch.from_numpy(far), torch.from_numpy(mic))["wav"]
    want = kalman_cancel_plain(cfg, torch.from_numpy(far), torch.from_numpy(mic))["wav"]
    assert got.shape == (2, 6 * 256 + 17)
    assert torch.equal(got, want)
    assert kalman_cancel_fused_batched.launches == before


def test_single_utterance_matches_batch_row(rng):
    cfg = KalmanConfig()
    far, mic = _scene(rng, b=2, n=8 * 256)
    batch = kalman_cancel(cfg, torch.from_numpy(far), torch.from_numpy(mic))["wav"]
    one = kalman_cancel(cfg, torch.from_numpy(far[1]), torch.from_numpy(mic[1]))["wav"]
    assert one.shape == (8 * 256,)
    # another matmul blocking at batch 1: round-off, carried by the recursion
    torch.testing.assert_close(one, batch[1], atol=1e-5 * float(np.abs(mic).max()), rtol=0)


def test_unconstrained_matches_jax(rng):
    cfg = KalmanConfig()
    far, mic = _scene(rng, b=2, n=8 * 256)
    want = np.asarray(
        jax_kalman_cancel(JaxKalmanConfig(), jnp.asarray(far), jnp.asarray(mic), constrain=False,
                          fused=False)["wav"]
    )
    got = kalman_cancel(cfg, torch.from_numpy(far), torch.from_numpy(mic), constrain=False)
    np.testing.assert_allclose(got["wav"].numpy(), want, atol=2e-4 * np.abs(want).max())


def test_fast_quality_not_ported_yet(rng):
    """quality="fast" (JAX's mixed bf16 tier) has no tier of its own in the
    port: it computes the same fp32 numbers as "parity"; unknown names raise."""
    far, mic = _scene(rng, b=2, n=4 * 256)
    args = (KalmanConfig(), torch.from_numpy(far), torch.from_numpy(mic))
    fast = kalman_cancel(*args, quality="fast")
    assert torch.equal(fast["wav"], kalman_cancel(*args)["wav"])
    with pytest.raises(ValueError, match="quality"):
        kalman_cancel(*args, quality="bf16")

