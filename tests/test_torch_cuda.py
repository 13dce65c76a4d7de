"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so on a machine with the
card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from aec_tpu_torch.configs import KalmanConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.kernels.kalman import kalman_cancel_fused_batched, kalman_cancel_plain
from aec_tpu_torch.kernels.stage2 import little_net_apply_fused, little_net_apply_fused_plain
from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
from aec_tpu_torch.utils.weights import load_npz

ROBUST = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "little_net_robust.npz")
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    return torch.device("cuda")


@pytest.fixture
def scene():
    rng = np.random.default_rng(1234)

    def make(b, n):
        far = rng.standard_normal((b, n)).astype(np.float32)
        rir = (np.exp(-np.arange(300) / 60.0) * rng.standard_normal(300)).astype(np.float32)
        mic = np.stack([np.convolve(far[i], 0.4 * rir)[:n] for i in range(b)])
        mic += 0.05 * rng.standard_normal((b, n))
        return torch.from_numpy(far), torch.from_numpy(mic.astype(np.float32))

    return make


def test_kalman_kernel_matches_plain(cuda, scene):
    cfg = KalmanConfig()
    far, mic = (t.to(cuda) for t in scene(5, 64 * 256 + 100))  # hop-fractional: padded
    before = kalman_cancel_fused_batched.launches
    got = kalman_cancel_fused_batched(cfg, far, mic)["wav"]
    torch.cuda.synchronize()
    assert kalman_cancel_fused_batched.launches == before + 1
    want = kalman_cancel_plain(cfg, far, mic)["wav"]
    assert got.shape == want.shape == mic.shape
    # fp32 with another summation order, carried by the recursion
    torch.testing.assert_close(got, want, atol=1e-3 * float(mic.abs().max()), rtol=0)


def test_kalman_kernel_refuses_what_it_cannot_take(cuda, scene):
    far, mic = (t.to(cuda) for t in scene(2, 8 * 256))
    with pytest.raises(ValueError):
        kalman_cancel_fused_batched(KalmanConfig(n_blocks=4), far, mic)
    with pytest.raises(TypeError):
        kalman_cancel_fused_batched(KalmanConfig(), far.double(), mic.double())
    with pytest.raises(ValueError):
        kalman_cancel_fused_batched(KalmanConfig(), far[:, ::2], mic[:, ::2])


@pytest.mark.parametrize("gain_norm", [False, True])
def test_stage2_kernel_matches_plain(cuda, scene, gain_norm):
    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    lin, far = (t.to(cuda).reshape(4, -1, 256) for t in scene(4, 40 * 256))
    before = little_net_apply_fused.launches
    with torch.no_grad():
        out, mask = little_net_apply_fused(net, lin, far, erb, gain_norm=gain_norm)
        torch.cuda.synchronize()
        want_out, want_mask = little_net_apply_fused_plain(net, lin, far, erb, gain_norm=gain_norm)
    assert little_net_apply_fused.launches == before + 1
    assert out.shape == (4, 40, 256) and mask.shape == (4, 41, 32)
    # fp32 round-off through DFT, GRU and pinv synthesis
    torch.testing.assert_close(out, want_out, atol=1e-4 * float(want_out.abs().max()), rtol=0)
    torch.testing.assert_close(mask, want_mask, atol=1e-5, rtol=0)


def test_stage2_kernel_refuses_a_wide_net(cuda, scene):
    net = load_npz(ROBUST.replace("robust", "dtalk_w2")).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    lin, far = (t.to(cuda).reshape(2, -1, 256) for t in scene(2, 8 * 256))
    with pytest.raises(ValueError):
        little_net_apply_fused(net, lin, far, erb)


def test_two_stage_kernel_route_matches_cpu_route(cuda, scene):
    far, mic = scene(3, 64 * 256)
    net = load_npz(ROBUST)
    want = two_stage_cancel(net, far, mic, erb_filterbank())
    k1, k2 = kalman_cancel_fused_batched.launches, little_net_apply_fused.launches
    got = two_stage_cancel(net.to(cuda), far.to(cuda), mic.to(cuda), erb_filterbank())
    assert kalman_cancel_fused_batched.launches == k1 + 1
    assert little_net_apply_fused.launches == k2 + 1
    for key in ("linear_wav", "wav"):
        w = want[key]
        torch.testing.assert_close(got[key].cpu(), w, atol=1e-3 * float(w.abs().max()), rtol=0)
    # a single utterance runs as a batch of one through both kernels
    one = two_stage_cancel(net, far[0].to(cuda), mic[0].to(cuda), erb_filterbank())
    assert one["wav"].shape == (64 * 256,)
    assert kalman_cancel_fused_batched.launches == k1 + 2
