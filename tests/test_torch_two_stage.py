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
from aec_tpu.models.little_net import little_net_init
from aec_tpu.pipeline.two_stage import two_stage_cancel as jax_two_stage
from aec_tpu.train import checkpoints
from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
from aec_tpu_torch.utils.weights import load_npz

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


@pytest.mark.parametrize("kwargs", [{"stage1": "nlms"}, {"quality": "fast"}, {"fast": True}])
def test_routes_not_ported_yet_raise(rng, kwargs):
    far, mic = _scene(rng, b=1, n=4 * 256)
    net = load_npz(os.path.join(CKPT_DIR, "little_net_robust.npz"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic),
                         erb_filterbank(), **kwargs)


def test_port_runs_without_jax():
    """The port imports and runs two_stage_cancel with jax and the JAX
    package blocked."""
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
        "assert not any(m.split('.')[0] in ('jax', 'aec_tpu') for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

