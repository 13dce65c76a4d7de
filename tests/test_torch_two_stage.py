"""Port two-stage pipeline (aec_tpu_torch.pipeline.two_stage) == JAX."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.dsp.erb import erb_filterbank
from aec_tpu.kernels.pallas_two_stage import two_stage_fused as jax_two_stage_fused
from aec_tpu.models.little_net import little_net_init
from aec_tpu.pipeline.two_stage import two_stage_cancel as jax_two_stage
from aec_tpu.train import checkpoints
from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain
from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
from aec_tpu_torch.utils.weights import load_npz, params_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT_DIR = os.path.join(ROOT, "checkpoints")


def _scene(rng, b=3, n=32 * 256):
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (np.exp(-np.arange(400) / 80.0) * rng.standard_normal(400)).astype(np.float32)
    near = 0.1 * rng.standard_normal((b, n)).astype(np.float32)
    mic = np.stack([np.convolve(far[i], 0.4 * rir)[:n] for i in range(b)]) + near
    return far, mic.astype(np.float32)


def _jax_params(name, width=1):
    return checkpoints.restore(
        os.path.join(CKPT_DIR, name),
        {"params": little_net_init(jax.random.PRNGKey(0), width=width)},
    )["params"]


@pytest.mark.parametrize("gain_norm", [False, True])
def test_two_stage_matches_jax(rng, gain_norm):
    far, mic = _scene(rng)
    erb = erb_filterbank()
    want = jax_two_stage(_jax_params("little_net_robust.npz"), jnp.asarray(far),
                         jnp.asarray(mic), jnp.asarray(erb), gain_norm=gain_norm)
    got = two_stage_cancel(load_npz(os.path.join(CKPT_DIR, "little_net_robust.npz")),
                           torch.from_numpy(far), torch.from_numpy(mic), erb,
                           gain_norm=gain_norm)
    lin_j = np.asarray(want["linear_wav"])
    wav_j = np.asarray(want["wav"])
    assert got["linear_wav"].shape == lin_j.shape and got["wav"].shape == wav_j.shape
    assert got["mask"].shape == want["mask"].shape
    # stage 1: the JAX suite's kernel-vs-scan bar; stage 2 compounds it
    np.testing.assert_allclose(got["linear_wav"].numpy(), lin_j, atol=2e-4 * np.abs(lin_j).max())
    np.testing.assert_allclose(got["wav"].numpy(), wav_j, atol=5e-4 * np.abs(wav_j).max())
    np.testing.assert_allclose(got["mask"].numpy(), np.asarray(want["mask"]), atol=1e-4)


def test_single_utterance_and_wide_checkpoint_match_jax(rng):
    """1-D input; a width-2 checkpoint takes the offline stage-2 apply, as the
    JAX routing guard sends it; normalize=True; a hop-fractional length."""
    far, mic = _scene(rng, b=1, n=20 * 256 + 40)
    erb = erb_filterbank()
    want = jax_two_stage(_jax_params("little_net_dtalk_w2.npz", width=2),
                         jnp.asarray(far[0]), jnp.asarray(mic[0]), jnp.asarray(erb),
                         normalize=True)
    got = two_stage_cancel(load_npz(os.path.join(CKPT_DIR, "little_net_dtalk_w2.npz")),
                           torch.from_numpy(far[0]), torch.from_numpy(mic[0]), erb,
                           normalize=True)
    wav_j = np.asarray(want["wav"])
    # the offline apply drops the hop-fractional tail, in both packages
    assert got["wav"].shape == wav_j.shape == (20 * 256,)
    np.testing.assert_allclose(got["wav"].numpy(), wav_j, atol=5e-4 * np.abs(wav_j).max())


def test_stage1_none_matches_jax(rng):
    far, mic = _scene(rng, b=2, n=12 * 256)
    erb = erb_filterbank()
    want = jax_two_stage(_jax_params("little_net_general.npz"), jnp.asarray(far),
                         jnp.asarray(mic), jnp.asarray(erb), stage1="none")
    got = two_stage_cancel(load_npz(os.path.join(CKPT_DIR, "little_net_general.npz")),
                           torch.from_numpy(far), torch.from_numpy(mic), erb, stage1="none")
    assert torch.equal(got["linear_wav"], torch.from_numpy(mic))
    wav_j = np.asarray(want["wav"])
    np.testing.assert_allclose(got["wav"].numpy(), wav_j, atol=1e-4 * np.abs(wav_j).max())


@pytest.mark.parametrize(
    "kwargs",
    [{"stage1": "nlms"}, {"stage1": "nlms", "quality": "fast"}, {"stage1": "nlms", "fast": True}],
)
def test_routes_not_ported_yet_raise(rng, kwargs):
    """stage1="nlms" is ported on every route: the parity route, "fast"
    (never K4: NLMS keeps the composition) and the legacy fast=True, which
    leaves NLMS's stage 1 alone. Each computes the parity route's numbers
    and JAX's at the parity bars."""
    far, mic = _scene(rng, b=1, n=16 * 256)
    erb = erb_filterbank()
    net = load_npz(os.path.join(CKPT_DIR, "little_net_robust.npz"))
    got = two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic), erb, **kwargs)
    parity = two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic), erb,
                              stage1="nlms")
    for key in ("wav", "linear_wav", "mask"):
        assert torch.equal(got[key], parity[key]), key
    want = jax_two_stage(_jax_params("little_net_robust.npz"), jnp.asarray(far),
                         jnp.asarray(mic), jnp.asarray(erb), **kwargs)
    lin_j, wav_j = np.asarray(want["linear_wav"]), np.asarray(want["wav"])
    np.testing.assert_allclose(got["linear_wav"].numpy(), lin_j, atol=2e-4 * np.abs(lin_j).max())
    np.testing.assert_allclose(got["wav"].numpy(), wav_j, atol=5e-4 * np.abs(wav_j).max())


@pytest.mark.parametrize("batched", [True, False])
def test_nlms_two_stage_matches_jax(rng, batched):
    """two_stage_cancel(stage1="nlms") vs JAX, a batch and a single
    utterance, with a non-default NlmsConfig: linear_wav at the stage-1 bar,
    wav and mask at the Kalman route's bars; a KalmanConfig is refused."""
    from aec_tpu.configs import NlmsConfig as JaxNlmsConfig
    from aec_tpu_torch.configs import KalmanConfig, NlmsConfig

    far, mic = _scene(rng, b=3, n=24 * 256)
    if not batched:
        far, mic = far[1], mic[1]
    erb = erb_filterbank()
    cfg = {"mu": 0.3, "beta": 0.5}
    want = jax_two_stage(_jax_params("little_net_robust.npz"), jnp.asarray(far),
                         jnp.asarray(mic), jnp.asarray(erb), stage1="nlms",
                         lin_cfg=JaxNlmsConfig(**cfg))
    net = load_npz(os.path.join(CKPT_DIR, "little_net_robust.npz"))
    got = two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic), erb,
                           stage1="nlms", lin_cfg=NlmsConfig(**cfg))
    lin_j, wav_j = np.asarray(want["linear_wav"]), np.asarray(want["wav"])
    assert got["wav"].shape == wav_j.shape == mic.shape
    assert got["mask"].shape == want["mask"].shape
    np.testing.assert_allclose(got["linear_wav"].numpy(), lin_j, atol=2e-4 * np.abs(lin_j).max())
    np.testing.assert_allclose(got["wav"].numpy(), wav_j, atol=5e-4 * np.abs(wav_j).max())
    np.testing.assert_allclose(got["mask"].numpy(), np.asarray(want["mask"]), atol=1e-4)
    with pytest.raises(TypeError, match="NlmsConfig"):
        two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic), erb, stage1="nlms",
                         lin_cfg=KalmanConfig())


@pytest.mark.parametrize("gain_norm", [False, True])
def test_two_stage_fused_plain_matches_jax_kernel(rng, gain_norm):
    """K4's plain version vs the TPU kernel it replaces, in interpret mode at
    the JAX suite's exact-numerics tier (tests/test_pallas_two_stage.py):
    wav and linear_wav at its 2e-3 of scale, the T + 1 mask frames."""
    params = little_net_init(jax.random.PRNGKey(5))
    far, mic = _scene(rng, b=3, n=20 * 256)
    erb = erb_filterbank()
    want = jax_two_stage_fused(params, jnp.asarray(far), jnp.asarray(mic), jnp.asarray(erb),
                               interpret=True, tile=2, dot_mode="high", gain_norm=gain_norm)
    got = two_stage_fused(params_from_jax(params), torch.from_numpy(far), torch.from_numpy(mic),
                          erb, gain_norm=gain_norm)
    plain = two_stage_fused_plain(params_from_jax(params), torch.from_numpy(far),
                                  torch.from_numpy(mic), erb, gain_norm=gain_norm)
    for key in ("wav", "linear_wav", "mask"):
        assert torch.equal(got[key], plain[key]), key  # the CPU wrapper is the plain version
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-9)
        np.testing.assert_allclose(got[key].numpy(), w, atol=2e-3 * scale, rtol=0, err_msg=key)
    assert got["mask"].shape == (3, 21, 32)


@pytest.mark.parametrize("kwargs", [{"quality": "fast"}, {"fast": True}])
def test_fast_routes_match_jax(rng, kwargs):
    """quality="fast" and the legacy fast=True on the CPU: the K1 + K2
    composition in fp32, equal to the parity route, and to JAX's fast route
    on the CPU (fp32 there too) at the parity bars."""
    far, mic = _scene(rng)
    erb = erb_filterbank()
    net = load_npz(os.path.join(CKPT_DIR, "little_net_robust.npz"))
    want = jax_two_stage(_jax_params("little_net_robust.npz"), jnp.asarray(far),
                         jnp.asarray(mic), jnp.asarray(erb), **kwargs)
    got = two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic), erb, **kwargs)
    parity = two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic), erb)
    for key in ("wav", "linear_wav", "mask"):
        assert torch.equal(got[key], parity[key]), key
    lin_j, wav_j = np.asarray(want["linear_wav"]), np.asarray(want["wav"])
    np.testing.assert_allclose(got["linear_wav"].numpy(), lin_j, atol=2e-4 * np.abs(lin_j).max())
    np.testing.assert_allclose(got["wav"].numpy(), wav_j, atol=5e-4 * np.abs(wav_j).max())


def test_port_runs_without_jax():
    """The port imports and runs two_stage_cancel (Kalman and NLMS),
    nlms_cancel, the streaming step and serving_step_plain(stage1="nlms")
    with jax and the JAX package blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['aec_tpu'] = None\n"
        "import numpy as np, torch\n"
        "from aec_tpu_torch import two_stage_cancel, load_npz, erb_filterbank\n"
        "rng = np.random.default_rng(0)\n"
        "far = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))\n"
        "mic = 0.5 * far + 0.1 * torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))\n"
        "out = two_stage_cancel(load_npz('checkpoints/little_net_robust.npz'), far, mic, erb_filterbank())\n"
        "assert out['wav'].shape == (2, 4096) and bool(torch.isfinite(out['wav']).all())\n"
        "from aec_tpu_torch import NlmsConfig, nlms_cancel, serving_init, serving_step_plain\n"
        "from aec_tpu_torch import stream_init_batched, stream_step_batched\n"
        "net = load_npz('checkpoints/little_net_robust.npz')\n"
        "out = two_stage_cancel(net, far, mic, erb_filterbank(), stage1='nlms')\n"
        "assert bool(torch.isfinite(out['wav']).all())\n"
        "assert nlms_cancel(NlmsConfig(), far[0], mic[0])['wav'].shape == (4096,)\n"
        "st, o = stream_step_batched(net, stream_init_batched(2, stage1='nlms'), far[:, :256],\n"
        "                            mic[:, :256], erb_filterbank(), stage1='nlms')\n"
        "ks, o = serving_step_plain(net, serving_init(2, stage1='nlms'), far[:, :256],\n"
        "                           mic[:, :256], erb_filterbank(), stage1='nlms')\n"
        "assert o.shape == (2, 256)\n"
        "assert not any(m.split('.')[0] in ('jax', 'aec_tpu') for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

