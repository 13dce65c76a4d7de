"""Port NLMS stage 1 (aec_tpu_torch.linear.nlms / kernels.nlms) == JAX."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.configs import NlmsConfig as JaxNlmsConfig
from aec_tpu.kernels.pallas_nlms import nlms_cancel_fused as jax_nlms_cancel_fused
from aec_tpu.kernels.pallas_nlms import nlms_cancel_fused_batched_bl
from aec_tpu.linear import overlap_save as jols
from aec_tpu.linear.nlms import nlms_cancel as jax_nlms_cancel
from aec_tpu.linear.nlms import nlms_filter as jax_nlms_filter
from aec_tpu_torch.configs import NlmsConfig
from aec_tpu_torch.kernels.nlms import nlms_cancel_fused, nlms_cancel_fused_batched
from aec_tpu_torch.linear.nlms import nlms_cancel, nlms_cancel_plain, nlms_filter

CLASSIC = {"eps_rel": 0.0, "beta": 0.0}  # the textbook update


def _scene(rng, b=5, n=24 * 256):
    """As tests/test_pallas_kalman.py draws the NLMS scenes: a 300-tap
    decaying RIR peak-normalized to 0.5, a low near-end floor."""
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (np.exp(-np.arange(300) / 60.0) * rng.standard_normal(300)).astype(np.float32)
    rir = 0.5 * rir / np.abs(rir).max()
    mic = np.stack([np.convolve(far[i], rir)[:n] for i in range(b)])
    mic += 0.01 * rng.standard_normal((b, n))
    return far, mic.astype(np.float32)


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-9)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=0, err_msg=what)


def test_config_restates_jax_config():
    assert dataclasses.asdict(NlmsConfig()) == dataclasses.asdict(JaxNlmsConfig())


@pytest.mark.parametrize("overrides", [{}, CLASSIC])
def test_nlms_cancel_matches_jax_scan(rng, overrides):
    """The plain loop vs JAX's scan at fp32: the wav and the final w, power
    and psi at 2e-4 of scale, the bar of test_torch_kalman.py."""
    far, mic = _scene(rng)
    out_j = jax_nlms_cancel(JaxNlmsConfig(**overrides), jnp.asarray(far), jnp.asarray(mic),
                            fused=False)
    out_t = nlms_cancel(NlmsConfig(**overrides), torch.from_numpy(far), torch.from_numpy(mic))
    assert out_t["wav"].shape == mic.shape
    _close(out_t["wav"].numpy(), out_j["wav"], 2e-4, "wav")
    assert sorted(out_t["state"]) == sorted(out_j["state"])
    for key in ("w", "power", "psi", "x_buf"):
        assert out_t["state"][key].shape == out_j["state"][key].shape, key
        _close(out_t["state"][key].numpy(), out_j["state"][key], 2e-4, key)



def test_nlms_filter_resumes_from_a_state(rng):
    """``nlms_filter``'s optional ``state``, JAX's fourth parameter: one
    utterance filtered in two halves, the state carried over, equals one
    pass (the same operations in the same order: bit for bit), and the
    second half and its final state equal JAX's ``nlms_filter`` given the
    same state at this file's bar (2e-4 of scale)."""
    cfg = NlmsConfig()
    far, mic = _scene(rng, b=1)
    x = np.array(jols.far_end_spectra(jnp.asarray(far[0]), 256))
    d = mic[0].reshape(-1, 256)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    half = x.shape[0] // 2
    e_all, s_all = nlms_filter(cfg, xt, dt)
    e1, s1 = nlms_filter(cfg, xt[:half], dt[:half])
    e2, s2 = nlms_filter(cfg, xt[half:], dt[half:], s1)
    assert torch.equal(torch.cat([e1, e2]), e_all)
    assert sorted(s2) == sorted(s_all) and all(torch.equal(s2[k], s_all[k]) for k in s_all)
    e_j, s_j = jax_nlms_filter(JaxNlmsConfig(), jnp.asarray(x[half:]), jnp.asarray(d[half:]),
                               {k: jnp.asarray(v.numpy()) for k, v in s1.items()})
    _close(e2.numpy(), e_j, 2e-4, "e")
    for key in ("w", "power", "psi", "x_buf"):
        _close(s2[key].numpy(), s_j[key], 2e-4, key)

def test_unconstrained_matches_jax(rng):
    far, mic = _scene(rng, b=2, n=12 * 256)
    want = jax_nlms_cancel(JaxNlmsConfig(), jnp.asarray(far), jnp.asarray(mic), constrain=False,
                           fused=False)
    got = nlms_cancel(NlmsConfig(), torch.from_numpy(far), torch.from_numpy(mic), constrain=False)
    _close(got["wav"].numpy(), want["wav"], 2e-4)
    assert got["state"] is not None


GEOMETRIES = [(256, 10), (160, 4)]  # (block, partitions): the default and the 160-sample hop


@pytest.mark.parametrize("block,n_blocks", GEOMETRIES)
def test_plain_matches_jax_batched_kernel(rng, block, n_blocks):
    """The plain version vs the TPU kernel K5 replaces, in interpret mode at
    its exact-numerics tier, at the default geometry and at block 160 with
    4 partitions; 5e-4 of scale, the JAX suite's own bar for that kernel
    against the scan (its factored constraint and in-kernel analysis add
    roundings the leakage-free NLMS integrator carries)."""
    far, mic = _scene(rng, n=24 * block)
    want = nlms_cancel_fused_batched_bl(JaxNlmsConfig(n_blocks=n_blocks), jnp.asarray(far),
                                        jnp.asarray(mic), block=block, interpret=True, tile=2,
                                        dot_mode="high")["wav"]
    got = nlms_cancel_fused_batched(NlmsConfig(n_blocks=n_blocks), torch.from_numpy(far),
                                    torch.from_numpy(mic), block=block)
    _close(got["wav"].numpy(), want, 5e-4)


@pytest.mark.parametrize("block,n_blocks", GEOMETRIES)
def test_single_stream_matches_jax_kernel(rng, block, n_blocks):
    """A 1-D input vs the TPU kernel K7 replaces (interpret mode, "high"),
    on a hop-fractional length, at the default geometry and at block 160
    with 4 partitions; 2e-4 of scale, the JAX suite's bar."""
    n = 20 * block + 77
    far, mic = _scene(rng, b=1, n=n)
    want = jax_nlms_cancel_fused(JaxNlmsConfig(n_blocks=n_blocks), jnp.asarray(far[0]),
                                 jnp.asarray(mic[0]), block=block, interpret=True,
                                 dot_mode="high")["wav"]
    got = nlms_cancel_fused(NlmsConfig(n_blocks=n_blocks), torch.from_numpy(far[0]),
                            torch.from_numpy(mic[0]), block=block)
    assert got["wav"].shape == (n,)
    _close(got["wav"].numpy(), want, 2e-4)


def test_wrappers_take_plain_version_on_cpu(rng):
    """K5 and K7 on CPU tensors run the plain loop: no launch counted, no
    step counted."""
    cfg = NlmsConfig()
    far, mic = _scene(rng, b=2, n=6 * 256 + 17)  # hop-fractional length: padded
    f, m = torch.from_numpy(far), torch.from_numpy(mic)
    before = nlms_cancel_fused_batched.launches, nlms_cancel_fused.launches
    steps = dict(nlms_cancel_fused_batched.steps), dict(nlms_cancel_fused.steps)
    batched = nlms_cancel_fused_batched(cfg, f, m)["wav"]
    one = nlms_cancel_fused(cfg, f[1], m[1])["wav"]
    assert batched.shape == (2, 6 * 256 + 17) and one.shape == (6 * 256 + 17,)
    assert torch.equal(batched, nlms_cancel_plain(cfg, f, m)["wav"])
    assert torch.equal(one, nlms_cancel_plain(cfg, f[1], m[1])["wav"])
    assert (nlms_cancel_fused_batched.launches, nlms_cancel_fused.launches) == before
    assert (nlms_cancel_fused_batched.steps, nlms_cancel_fused.steps) == steps
    assert set(steps[0]) == set(steps[1]) == {"fft", "dense"}


def test_single_utterance_matches_batch_row(rng):
    cfg = NlmsConfig()
    far, mic = _scene(rng, b=2, n=8 * 256)
    batch = nlms_cancel(cfg, torch.from_numpy(far), torch.from_numpy(mic))["wav"]
    one = nlms_cancel(cfg, torch.from_numpy(far[1]), torch.from_numpy(mic[1]))["wav"]
    assert one.shape == (8 * 256,)
    # another matmul blocking at batch 1: round-off, carried by the recursion
    torch.testing.assert_close(one, batch[1], atol=1e-5 * float(np.abs(mic).max()), rtol=0)


def test_quality_routes_identically(rng):
    """NLMS has no mixed tier: "fast" computes what "parity" does."""
    far, mic = _scene(rng, b=2, n=4 * 256)
    args = (NlmsConfig(), torch.from_numpy(far), torch.from_numpy(mic))
    assert torch.equal(nlms_cancel(*args, quality="fast")["wav"], nlms_cancel(*args)["wav"])
    with pytest.raises(ValueError, match="quality"):
        nlms_cancel(*args, quality="mixed")


@pytest.mark.slow
def test_scene_battery_tail_erle_matches_jax():
    """The 8 scenes of benchmarks/scenes.py at 8.2 s through the port's CPU
    NLMS and JAX's CPU NLMS: tail ERLE within 0.1 dB per scene."""
    from benchmarks.scenes import erle_tail, make_scenes

    scenes = make_scenes(np.random.default_rng(0), n=131072)
    far = np.stack([v[0] for v in scenes.values()])
    mic = np.stack([v[1] for v in scenes.values()])
    got = nlms_cancel(NlmsConfig(), torch.from_numpy(far), torch.from_numpy(mic))["wav"].numpy()
    want = np.asarray(jax_nlms_cancel(JaxNlmsConfig(), jnp.asarray(far), jnp.asarray(mic),
                                      fused=False)["wav"])
    for i, name in enumerate(scenes):
        d = abs(erle_tail(mic[i], got[i]) - erle_tail(mic[i], want[i]))
        assert d <= 0.1, (name, d)
