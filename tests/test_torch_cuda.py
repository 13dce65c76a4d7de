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

from aec_tpu_torch.configs import KalmanConfig, NlmsConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.kernels.gru import (
    gru_backward,
    gru_backward_plain,
    gru_recurrence,
    gru_scan_fused,
    gru_scan_fused_plain,
    wide_fits,
)
from aec_tpu_torch.kernels.kalman import (
    kalman_cancel_fused,
    kalman_cancel_fused_batched,
    kalman_cancel_plain,
    kalman_filter_fused_batched,
    kalman_filter_fused_batched_plain,
)
from aec_tpu_torch.kernels.nlms import (
    nlms_cancel_fused,
    nlms_cancel_fused_batched,
    nlms_cancel_plain,
)
from aec_tpu_torch.linear import overlap_save as ols
from aec_tpu_torch.linear.kalman import kalman_cancel
from aec_tpu_torch.kernels.stage2 import little_net_apply_fused, little_net_apply_fused_plain
from aec_tpu_torch.models.little_net import little_net_init, little_net_loss
from aec_tpu_torch.ops.gru import gru_init, gru_scan, kernel_route
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
    """Refusals at real limits only: 30 partitions at block 256 need more
    shared memory than one CTA has (24 fit); another dtype; a strided input."""
    far, mic = (t.to(cuda) for t in scene(2, 8 * 256))
    with pytest.raises(ValueError, match="shared memory"):
        kalman_cancel_fused_batched(KalmanConfig(n_blocks=30), far, mic)
    with pytest.raises(TypeError):
        kalman_cancel_fused_batched(KalmanConfig(), far.double(), mic.double())
    with pytest.raises(ValueError):
        kalman_cancel_fused_batched(KalmanConfig(), far[:, ::2], mic[:, ::2])


@pytest.mark.parametrize("gain_norm", [False, True])
def test_stage2_kernel_matches_plain(cuda, scene, gain_norm):
    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    lin, far = (t.to(cuda).reshape(4, -1, 256) for t in scene(4, 40 * 256))
    before = little_net_apply_fused.launches, gru_recurrence.launches
    with torch.no_grad():
        out, mask = little_net_apply_fused(net, lin, far, erb, gain_norm=gain_norm)
        torch.cuda.synchronize()
        want_out, want_mask = little_net_apply_fused_plain(net, lin, far, erb, gain_norm=gain_norm)
    # phases A and C, and the recurrence (phase B) on K8
    assert (little_net_apply_fused.launches, gru_recurrence.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    assert out.shape == (4, 40, 256) and mask.shape == (4, 41, 32)
    # fp32 round-off through DFT, GRU and pinv synthesis
    torch.testing.assert_close(out, want_out, atol=1e-4 * float(want_out.abs().max()), rtol=0)
    torch.testing.assert_close(mask, want_mask, atol=1e-5, rtol=0)


@pytest.mark.parametrize("batch,t_blocks,hop,bands,gain_norm,transforms", [
    (256, 512, 256, 32, False, "fft"),  # the main path: 256 x 8.2 s
    (256, 1000, 256, 32, True, "fft"),  # 256 x 16 s
    (3, 512, 256, 32, True, "fft"),
    (3, 1000, 256, 32, False, "fft"),
    (1, 512, 256, 32, False, "fft"),  # a batch of one, as the one-utterance route runs it
    (1, 1000, 256, 32, True, "fft"),
    (4, 60, 160, 32, True, "fft"),  # the 320 / 160 / 320 STFT: plan 8, 4, 5
    (4, 60, 224, 32, False, "dense"),  # 224 = 2^5 7: no FFT plan
    (2, 60, 256, 64, True, "fft"),  # E = 64: K8's four-lane path
    (3, 1, 256, 32, False, "fft"),  # Tb = 1: the first and the flush frame only
    (2, 20, 1024, 32, True, "fft"),  # a long hop: runs shortened to fit shared memory
    (2, 20, 896, 32, False, "dense"),  # 896 = 2^7 7, long and without a plan
])
def test_stage2_kernel_shapes_match_plain(cuda, batch, t_blocks, hop, bands, gain_norm,
                                          transforms):
    """K2's phases against its plain version at the batches, lengths, hops
    and band counts its routes give it, at the kernel's bars; the wrapper
    counts the transforms that ran (FFTs, or dense ones for a hop without
    a radix plan) and one K8 launch per call. An untrained net keeps the
    mask off its rails (the robust checkpoint mutes this synthetic input to
    a mask of 0); the input level falls with the hop so the ERB features,
    sums over more bins, stay in the main path's range."""
    from aec_tpu_torch.dsp.stft import StftConfig

    cfg = StftConfig(2 * hop, hop, 2 * hop)
    g = torch.Generator(device=cuda).manual_seed(batch * t_blocks + hop + bands)
    net = little_net_init(bands, generator=torch.Generator().manual_seed(2), device=cuda)
    erb = torch.from_numpy(erb_filterbank(n_freqs=cfg.n_freqs, n_bands=bands)).to(cuda)
    level = 0.25 * 256 / hop
    far = level * torch.randn(batch, t_blocks, hop, generator=g, device=cuda)
    # a residual echo of the far end over a near-end floor
    lin = 0.3 * far + 0.05 * level * torch.randn(batch, t_blocks, hop, generator=g, device=cuda)
    before = (dict(little_net_apply_fused.transforms), gru_recurrence.launches)
    with torch.no_grad():
        out, mask = little_net_apply_fused(net, lin, far, erb, cfg, gain_norm=gain_norm)
        torch.cuda.synchronize()
        want_out, want_mask = little_net_apply_fused_plain(net, lin, far, erb, cfg,
                                                           gain_norm=gain_norm)
    ran = {k: v - before[0][k] for k, v in little_net_apply_fused.transforms.items()}
    assert ran == {"fft": int(transforms == "fft"), "dense": int(transforms == "dense")}
    assert gru_recurrence.launches == before[1] + 1
    assert out.shape == lin.shape and mask.shape == (batch, t_blocks + 1, bands)
    assert 0.05 < float(want_mask.mean()) < 0.95
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
    net = load_npz(ROBUST, device="cpu")
    want = two_stage_cancel(net, far, mic, erb_filterbank())
    k1, k2 = kalman_cancel_fused_batched.launches, little_net_apply_fused.launches
    k8 = gru_recurrence.launches
    got = two_stage_cancel(net.to(cuda), far.to(cuda), mic.to(cuda), erb_filterbank())
    assert kalman_cancel_fused_batched.launches == k1 + 1
    assert little_net_apply_fused.launches == k2 + 1 and gru_recurrence.launches == k8 + 1
    for key in ("linear_wav", "wav"):
        w = want[key]
        torch.testing.assert_close(got[key].cpu(), w, atol=1e-3 * float(w.abs().max()), rtol=0)
    # a single utterance: stage 1 on the single-stream kernel K6, stage 2
    # on K2 as a batch of one
    k6 = kalman_cancel_fused.launches
    one = two_stage_cancel(net, far[0].to(cuda), mic[0].to(cuda), erb_filterbank())
    assert one["wav"].shape == (64 * 256,)
    assert kalman_cancel_fused_batched.launches == k1 + 1
    assert kalman_cancel_fused.launches == k6 + 1 and little_net_apply_fused.launches == k2 + 2
    assert gru_recurrence.launches == k8 + 2  # K2's phase B


def _leaf_close(got, want, rel, what):
    for key in want:
        scale = max(float(want[key].abs().max()), 1e-9)
        torch.testing.assert_close(got[key], want[key], atol=rel * scale, rtol=0,
                                   msg=lambda m, key=key: f"{what} {key}: {m}")


@pytest.mark.parametrize("k,normalize,gain_norm", [(1, False, False), (3, True, False),
                                                   (1, True, True), (3, False, True)])
def test_serving_kernel_matches_plain(cuda, scene, k, normalize, gain_norm):
    """K3 vs serving_step_plain on the card: 4 calls of k blocks for 6
    streams, streams 1 and 4 reset after the second call; every output block
    and every state leaf, monitor rows included. fp32 in another summation
    order, carried by the Kalman recursion: K1's bar of 1e-3 of scale."""
    from aec_tpu_torch.kernels.serving import (
        serving_init,
        serving_reset_streams,
        serving_step_fused,
        serving_step_plain,
    )

    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    s, hop = 6, 256
    far, mic = (t.to(cuda) for t in scene(s, 4 * k * hop))
    ks, ps = serving_init(s, device=cuda), serving_init(s, device=cuda)
    done = torch.tensor([False, True, False, False, True, False], device=cuda)
    before = serving_step_fused.launches
    for c in range(4):
        cols = slice(c * k * hop, (c + 1) * k * hop)
        fb, mb = far[:, cols].contiguous(), mic[:, cols].contiguous()
        ks, ok = serving_step_fused(net, ks, fb, mb, erb, normalize=normalize, gain_norm=gain_norm)
        torch.cuda.synchronize()
        ps, op = serving_step_plain(net, ps, fb, mb, erb, normalize=normalize, gain_norm=gain_norm)
        assert ok.shape == op.shape == (s, k * hop)
        torch.testing.assert_close(ok, op, atol=1e-3 * float(op.abs().max()), rtol=0)
        if c == 1:
            serving_reset_streams(ks, done)
            serving_reset_streams(ps, done)
    assert serving_step_fused.launches == before + 4
    _leaf_close(ks, ps, 1e-3, "state")


def test_serving_kernel_refuses_what_it_cannot_take(cuda, scene):
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused

    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    far, mic = (t.to(cuda) for t in scene(2, 256))
    # stage1="nlms" runs on an NLMS state and is refused on a Kalman one
    # (its `p` leaf is (S, L, K), NLMS's is (S, K))
    _, out = serving_step_fused(net, serving_init(2, stage1="nlms", device=cuda), far, mic, erb,
                                stage1="nlms")
    assert out.shape == (2, 256) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="'p'"):
        serving_step_fused(net, serving_init(2, device=cuda), far, mic, erb, stage1="nlms")
    with pytest.raises(ValueError):  # state on the CPU: no silent plain run
        serving_step_fused(net, serving_init(2, device="cpu"), far, mic, erb)
    with pytest.raises(ValueError):  # a width-2 net
        serving_step_fused(load_npz(ROBUST.replace("robust", "dtalk_w2")).to(cuda),
                           serving_init(2, e_bands=32, device=cuda), far, mic, erb)


@pytest.mark.parametrize("stage1", ["kalman", "nlms"])
@pytest.mark.parametrize("s,k", [(1, 1), (1, 4), (8, 1), (8, 4), (1024, 1), (1024, 4)])
def test_serving_kernel_streams_with_options(cuda, scene, stage1, s, k):
    """K3 at a stream alone, at the 8 of the streamed scenes and at 1024, k
    = 1 and 4, with normalize and gain_norm, both filters: 3 calls against
    serving_step_plain at 1e-3 of scale (outputs and every state leaf); the
    FFT hop counted in ``steps``."""
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain

    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    far, mic = (t.to(cuda) for t in scene(s, 3 * k * 256))
    ks, ps = (serving_init(s, stage1=stage1, device=cuda) for _ in range(2))
    before = dict(serving_step_fused.steps)
    kw = {"stage1": stage1, "normalize": True, "gain_norm": True}
    with torch.no_grad():
        for c in range(3):
            cols = slice(c * k * 256, (c + 1) * k * 256)
            fb, mb = far[:, cols].contiguous(), mic[:, cols].contiguous()
            ks, ok = serving_step_fused(net, ks, fb, mb, erb, **kw)
            ps, op = serving_step_plain(net, ps, fb, mb, erb, **kw)
            torch.testing.assert_close(ok, op, atol=1e-3 * float(op.abs().max()), rtol=0)
    assert serving_step_fused.steps == {**before, "fft": before["fft"] + 3}
    _leaf_close(ks, ps, 1e-3, "state")


def test_serving_kernel_follows_in_place_weight_changes(cuda, scene):
    """K3's prepared constants are keyed on the weights' addresses and
    versions: after an in-place change to two weights (as an optimizer step
    makes) and after ``load_state_dict`` of the old weights, each next call
    gives the net's output of the moment, which differs from the previous
    weights' by far more than the bar."""
    import copy

    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain

    net = load_npz(ROBUST).to(cuda)
    old = copy.deepcopy(net)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    far, mic = (t.to(cuda) for t in scene(4, 6 * 256))
    ks, ps = serving_init(4, device=cuda), serving_init(4, device=cuda)
    with torch.no_grad():
        for u in range(6):
            fb, mb = (t[:, u * 256:(u + 1) * 256].contiguous() for t in (far, mic))
            if u == 2:
                net.linear2.bias.add_(0.5)
                net.gru1.weight_hh_l0.mul_(0.9)
                previous = old
            if u == 4:
                previous = copy.deepcopy(net)
                net.load_state_dict(old.state_dict())
            was = {key: v.clone() for key, v in ps.items()}
            ks, ok = serving_step_fused(net, ks, fb, mb, erb)
            ps, op = serving_step_plain(net, ps, fb, mb, erb)
            bar = 1e-3 * float(op.abs().max())
            torch.testing.assert_close(ok, op, atol=bar, rtol=0)
            if u in (2, 4):  # what a launch on the previous weights would give
                _, stale = serving_step_plain(previous, was, fb, mb, erb)
                assert float((op - stale).abs().max()) > 10 * bar
    _leaf_close(ks, ps, 1e-3, "state")


@pytest.mark.parametrize("batch", [1, 3, 256])
def test_two_stage_kernel_batches(cuda, scene, batch):
    """K4 at batch 1, 3 and 256 (CTAs from far fewer than the card holds to
    about as many) against the plain composition at the bars of
    test_two_stage_kernel_matches_plain (mask at the geometry tests' 1e-3);
    the FFT hop counted."""
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain

    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    far, mic = (t.to(cuda) for t in scene(batch, 24 * 256))
    before = dict(two_stage_fused.steps)
    with torch.no_grad():
        got = two_stage_fused(net, far, mic, erb)
        want = two_stage_fused_plain(net, far, mic, erb)
    assert two_stage_fused.steps == {**before, "fft": before["fft"] + 1}
    torch.testing.assert_close(got["linear_wav"], want["linear_wav"],
                               atol=1e-3 * float(mic.abs().max()), rtol=0)
    torch.testing.assert_close(got["wav"], want["wav"],
                               atol=1e-3 * float(want["wav"].abs().max()), rtol=0)
    torch.testing.assert_close(got["mask"], want["mask"], atol=1e-3, rtol=0)


def test_serving_and_two_stage_take_the_dense_hop_at_block_224(cuda, scene):
    """At block 224 (= 2^5 7: no radix plan) K3 (both filters) and K4 run
    the dense hop, count it in ``steps``, and agree with their plain
    versions at the geometry tests' bars."""
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain

    hop = 224
    scfg = StftConfig(2 * hop, hop, 2 * hop)
    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank(n_freqs=scfg.n_freqs)).to(cuda)
    far, mic = (t.to(cuda) for t in scene(3, 12 * hop))
    kcfg = KalmanConfig(n_blocks=4)
    before = dict(two_stage_fused.steps), dict(serving_step_fused.steps)
    with torch.no_grad():
        got = two_stage_fused(net, far, mic, erb, kcfg=kcfg, scfg=scfg)
        want = two_stage_fused_plain(net, far, mic, erb, kcfg=kcfg, scfg=scfg)
        torch.testing.assert_close(got["linear_wav"], want["linear_wav"],
                                   atol=1e-3 * float(mic.abs().max()), rtol=0)
        torch.testing.assert_close(got["wav"], want["wav"],
                                   atol=1e-3 * float(want["wav"].abs().max()), rtol=0)
        torch.testing.assert_close(got["mask"], want["mask"], atol=1e-3, rtol=0)
        for stage1, cfg in (("kalman", kcfg), ("nlms", NlmsConfig(n_blocks=4))):
            ks, ps = (serving_init(3, kcfg=cfg, scfg=scfg, stage1=stage1, device=cuda)
                      for _ in range(2))
            for u in range(0, 12 * hop, 3 * hop):
                fb, mb = far[:, u:u + 3 * hop].contiguous(), mic[:, u:u + 3 * hop].contiguous()
                ks, o_k = serving_step_fused(net, ks, fb, mb, erb, cfg, scfg, stage1=stage1,
                                             normalize=True)
                ps, o_p = serving_step_plain(net, ps, fb, mb, erb, cfg, scfg, stage1=stage1,
                                             normalize=True)
                torch.testing.assert_close(o_k, o_p, atol=1e-3 * float(o_p.abs().max()), rtol=0)
            _leaf_close(ks, ps, 1e-3, f"{stage1} state")
    assert two_stage_fused.steps == {**before[0], "dense": before[0]["dense"] + 1}
    assert serving_step_fused.steps == {**before[1], "dense": before[1]["dense"] + 8}


@pytest.mark.parametrize("gain_norm", [False, True])
def test_two_stage_kernel_matches_plain(cuda, scene, gain_norm):
    """K4 vs the K1-plain + K2-plain composition: linear_wav at K1's bar,
    wav at 1e-3 of scale (K2's input differs by K1's round-off), mask 1e-4."""
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain

    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    far, mic = (t.to(cuda) for t in scene(5, 48 * 256))
    before = two_stage_fused.launches
    got = two_stage_fused(net, far, mic, erb, gain_norm=gain_norm)
    torch.cuda.synchronize()
    assert two_stage_fused.launches == before + 1
    want = two_stage_fused_plain(net, far, mic, erb, gain_norm=gain_norm)
    assert got["mask"].shape == want["mask"].shape == (5, 49, 32)
    torch.testing.assert_close(got["linear_wav"], want["linear_wav"],
                               atol=1e-3 * float(mic.abs().max()), rtol=0)
    torch.testing.assert_close(got["wav"], want["wav"],
                               atol=1e-3 * float(want["wav"].abs().max()), rtol=0)
    torch.testing.assert_close(got["mask"], want["mask"], atol=1e-4, rtol=0)


def test_fast_route_launches_two_stage_kernel(cuda, scene):
    """quality="fast" on a batch takes K4; fast=True keeps the K1 + K2
    composition and a single utterance K6 + K2; stage1="nlms" with
    quality="fast" takes K5 + K2 and never K4."""
    from aec_tpu_torch.kernels.two_stage import two_stage_fused

    far, mic = (t.to(cuda) for t in scene(3, 32 * 256))
    net, erb = load_npz(ROBUST).to(cuda), erb_filterbank()
    k4, k1, k6 = (two_stage_fused.launches, kalman_cancel_fused_batched.launches,
                  kalman_cancel_fused.launches)
    fast = two_stage_cancel(net, far, mic, erb, quality="fast")
    assert two_stage_fused.launches == k4 + 1 and kalman_cancel_fused_batched.launches == k1
    legacy = two_stage_cancel(net, far, mic, erb, fast=True)
    one = two_stage_cancel(net, far[0], mic[0], erb, quality="fast")
    assert two_stage_fused.launches == k4 + 1 and kalman_cancel_fused_batched.launches == k1 + 1
    assert kalman_cancel_fused.launches == k6 + 1
    for key in ("wav", "linear_wav"):
        scale = float(legacy[key].abs().max())
        torch.testing.assert_close(fast[key], legacy[key], atol=1e-3 * scale, rtol=0)
        torch.testing.assert_close(one[key], legacy[key][0], atol=1e-3 * scale, rtol=0)
    k5, k2 = nlms_cancel_fused_batched.launches, little_net_apply_fused.launches
    nl = two_stage_cancel(net, far, mic, erb, stage1="nlms", quality="fast")
    assert nlms_cancel_fused_batched.launches == k5 + 1 and little_net_apply_fused.launches == k2 + 1
    assert two_stage_fused.launches == k4 + 1
    assert nl["wav"].shape == mic.shape and bool(torch.isfinite(nl["wav"]).all())


def test_nlms_kernel_matches_plain(cuda, scene):
    """K5 vs its plain version: fp32 in another summation order, carried by
    the recursion (K1's bar of 1e-3 of max|mic|)."""
    cfg = NlmsConfig()
    far, mic = (t.to(cuda) for t in scene(5, 64 * 256 + 100))  # hop-fractional: padded
    before = nlms_cancel_fused_batched.launches
    got = nlms_cancel_fused_batched(cfg, far, mic)["wav"]
    torch.cuda.synchronize()
    assert nlms_cancel_fused_batched.launches == before + 1
    want = nlms_cancel_plain(cfg, far, mic)["wav"]
    assert got.shape == want.shape == mic.shape
    torch.testing.assert_close(got, want, atol=1e-3 * float(mic.abs().max()), rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["kalman", "nlms"])
def test_single_stream_kernels_match_plain(cuda, which, seed):
    """K6 / K7 vs the plain loop on one hop-fractional utterance, twice with
    other inputs (a race between the warps' phases would show as a small,
    input-dependent error); K6 also against K1 as a batch of one (the same
    FFT step, its transforms in one warp each)."""
    rng = np.random.default_rng(seed)
    n = 96 * 256 + 51
    far = rng.standard_normal(n).astype(np.float32)
    rir = (np.exp(-np.arange(300) / 60.0) * rng.standard_normal(300)).astype(np.float32)
    mic = (np.convolve(far, 0.4 * rir)[:n] + 0.01 * rng.standard_normal(n)).astype(np.float32)
    far, mic = torch.from_numpy(far).to(cuda), torch.from_numpy(mic).to(cuda)
    cfg = KalmanConfig() if which == "kalman" else NlmsConfig()
    fused, plain = ((kalman_cancel_fused, kalman_cancel_plain) if which == "kalman"
                    else (nlms_cancel_fused, nlms_cancel_plain))
    before = fused.launches
    got = fused(cfg, far, mic)["wav"]
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    want = plain(cfg, far, mic)["wav"]
    assert got.shape == want.shape == (n,)
    bar = 1e-3 * float(mic.abs().max())
    torch.testing.assert_close(got, want, atol=bar, rtol=0)
    if which == "kalman":
        k1 = kalman_cancel_fused_batched(cfg, far[None], mic[None])["wav"][0]
        torch.testing.assert_close(got, k1, atol=bar, rtol=0)


def test_stage1_kernels_refuse_what_they_cannot_take(cuda, scene):
    """K5, K6 and K7 raise on a partition count whose state one CTA's shared
    memory cannot hold, a CPU/CUDA mix, a non-contiguous input and the other
    kind of input (a batch to K6/K7, one utterance to K5)."""
    far, mic = (t.to(cuda) for t in scene(2, 8 * 256))
    cases = ((nlms_cancel_fused_batched, NlmsConfig, far, mic),
             (kalman_cancel_fused, KalmanConfig, far[0], mic[0]),
             (nlms_cancel_fused, NlmsConfig, far[0], mic[0]))
    for fn, cfg, f, m in cases:
        with pytest.raises(ValueError, match="shared memory"):  # above 27 (K5), 29 (K6), 36 (K7)
            fn(cfg(n_blocks=40), f, m)
        with pytest.raises(ValueError, match="CUDA"):  # no silent plain run
            fn(cfg(), f, m.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            fn(cfg(), f[..., ::2], m[..., ::2])
        other = (far[0], mic[0]) if f.ndim == 2 else (far, mic)
        with pytest.raises(ValueError, match="shape"):
            fn(cfg(), *other)


def test_single_utterance_routes_to_the_single_stream_kernels(cuda, scene):
    """A 1-D CUDA kalman_cancel / nlms_cancel launches K6 / K7 and never the
    batched kernels; constrain=False stays on the plain loop."""
    far, mic = (t.to(cuda)[0].contiguous() for t in scene(1, 16 * 256))
    counts = lambda: (kalman_cancel_fused_batched.launches, kalman_cancel_fused.launches,  # noqa: E731
                      nlms_cancel_fused_batched.launches, nlms_cancel_fused.launches)
    from aec_tpu_torch.linear.nlms import nlms_cancel

    k1, k6, k5, k7 = counts()
    assert kalman_cancel(KalmanConfig(), far, mic)["state"] is None
    assert nlms_cancel(NlmsConfig(), far, mic)["state"] is None
    assert counts() == (k1, k6 + 1, k5, k7 + 1)
    assert kalman_cancel(KalmanConfig(), far, mic, constrain=False)["state"] is not None
    assert counts() == (k1, k6 + 1, k5, k7 + 1)


@pytest.mark.parametrize("k", [1, 4])
def test_nlms_serving_kernel_matches_plain(cuda, scene, k):
    """K3 with the NLMS stage 1 vs serving_step_plain(stage1="nlms"): 3
    calls of k blocks for 6 streams, stream 2 reset after the first; every
    output block and state leaf at 1e-3 of scale, as the Kalman K3."""
    from aec_tpu_torch.kernels.serving import (
        serving_init,
        serving_reset_streams,
        serving_step_fused,
        serving_step_plain,
    )

    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    s, hop = 6, 256
    far, mic = (t.to(cuda) for t in scene(s, 3 * k * hop))
    ks, ps = (serving_init(s, stage1="nlms", device=cuda) for _ in range(2))
    done = torch.tensor([False, False, True, False, False, False], device=cuda)
    before = serving_step_fused.launches
    for c in range(3):
        cols = slice(c * k * hop, (c + 1) * k * hop)
        fb, mb = far[:, cols].contiguous(), mic[:, cols].contiguous()
        ks, ok = serving_step_fused(net, ks, fb, mb, erb, stage1="nlms")
        torch.cuda.synchronize()
        ps, op = serving_step_plain(net, ps, fb, mb, erb, stage1="nlms")
        torch.testing.assert_close(ok, op, atol=1e-3 * float(op.abs().max()), rtol=0)
        if c == 0:
            serving_reset_streams(ks, done, stage1="nlms")
            serving_reset_streams(ps, done, stage1="nlms")
    assert serving_step_fused.launches == before + 3
    _leaf_close(ks, ps, 1e-3, "state")


def _gru_case(cuda, b, t, h, i=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = gru_init(i, h, generator=g, device=cuda)
    x = torch.randn(b, t, i, generator=g).to(cuda)
    h0 = (0.5 * torch.randn(b, h, generator=g)).to(cuda)
    return params, x, h0


@pytest.mark.parametrize("b,h", [(1, 32), (3, 32), (1, 128), (3, 128), (1, 129), (1, 512),
                                 (2, 300)])
def test_gru_kernel_matches_plain(cuda, b, h):
    """K8 vs its plain version over T = 101 steps (a multiple of no unroll),
    H <= 128 on one CTA per row, wider on the grid path: h stays in
    [-1, 1], fp32 in another summation order -> 1e-5 absolute."""
    params, x, h0 = _gru_case(cuda, b, 101, h)
    before = gru_recurrence.launches
    with torch.no_grad():
        ys, h_t = gru_scan_fused(params, x, h0)
        torch.cuda.synchronize()
        want, want_h = gru_scan_fused_plain(params, x, h0)
        scan, _ = gru_scan(params, x, h0, fused=False)
    assert gru_recurrence.launches == before + 1
    assert ys.shape == (b, 101, h) and torch.equal(h_t, ys[:, -1])
    torch.testing.assert_close(ys, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(ys, scan, atol=1e-5, rtol=0)
    # gru_scan's own route at T >= 64 (ops.gru.kernel_route) takes K8 at any
    # B to H = 128 and wherever the wide plan holds above (every case here)
    with torch.no_grad():
        routed, _ = gru_scan(params, x, h0)
    routes = kernel_route(b, 101, h, "cuda")
    assert routes == (h <= 128 or wide_fits(b, h)) and routes
    assert gru_recurrence.launches == before + 1 + routes
    if routes:
        torch.testing.assert_close(routed, ys, atol=0, rtol=0)


@pytest.mark.parametrize("t", [1, 63, 1001])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h", [1, 7, 32, 64, 100, 128])
def test_gru_register_kernel_matches_plain(cuda, h, b, t):
    """K8's one-CTA kernel (W_hh in registers: one warp to H = 32, four
    lanes a unit above) against its plain recurrence at every lane plan it
    has, one step, a step short of the routing threshold and a 16 s
    utterance: h stays in [-1, 1], fp32 in another summation order -> 1e-5
    absolute."""
    from aec_tpu_torch.kernels.gru import folded_projection, gru_recurrence_plain

    params, x, h0 = _gru_case(cuda, b, t, h, seed=h + b + t)
    xp = folded_projection(params, x)
    b_hn = params["b_hh"][2 * h:]
    before = gru_recurrence.launches
    with torch.no_grad():
        ys = gru_recurrence(xp, params["w_hh"], b_hn, h0)
        torch.cuda.synchronize()
        want = gru_recurrence_plain(xp, params["w_hh"], b_hn, h0)
    assert gru_recurrence.launches == before + 1
    assert ys.shape == (b, t, h) and bool(torch.isfinite(ys).all())
    torch.testing.assert_close(ys, want, atol=1e-5, rtol=0)


def test_gru_kernel_refuses_what_it_cannot_take(cuda):
    params, x, h0 = _gru_case(cuda, 2, 9, 32)
    from aec_tpu_torch.kernels.gru import folded_projection

    xp = folded_projection(params, x)
    b_hn = params["b_hh"][64:]
    with pytest.raises(TypeError):
        gru_recurrence(xp.double(), params["w_hh"].double(), b_hn.double(), h0.double())
    with pytest.raises(ValueError, match="contiguous"):
        gru_recurrence(xp.transpose(0, 1).contiguous().transpose(0, 1), params["w_hh"], b_hn, h0)
    with pytest.raises(ValueError, match="CUDA"):  # no silent plain run
        gru_recurrence(xp, params["w_hh"], b_hn, h0.cpu())
    with pytest.raises(ValueError, match="T >= 1"):
        gru_recurrence(xp[:, :0].contiguous(), params["w_hh"], b_hn, h0)


def test_gru_gradients_through_kernel_equal_plain_route(cuda):
    """A batch-1 T >= 64 scan on the card routes to K8; its gradients (K8b
    on the gates K8 saved) equal the plain route's to 1e-5 of scale."""
    params, x, h0 = _gru_case(cuda, 1, 200, 32)
    leaves = [x, h0, *params.values()]
    for t in leaves:
        t.requires_grad_()
    before = gru_recurrence.launches, gru_backward.launches
    ys, h_t = gru_scan(params, x, h0)
    assert gru_recurrence.launches == before[0] + 1
    got = torch.autograd.grad((ys * ys).sum() + h_t.sum(), leaves)
    assert gru_backward.launches == before[1] + 1
    ys2, h2 = gru_scan(params, x, h0, fused=False)
    want = torch.autograd.grad((ys2 * ys2).sum() + h2.sum(), leaves)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5 * float(w.abs().max()), rtol=0)


def _saved_case(cuda, b, t, h, seed=0):
    """K8's training launch on a random case: (g_ys, gates, ys, h0, w_hh)."""
    from aec_tpu_torch.kernels.gru import folded_projection

    params, x, h0 = _gru_case(cuda, b, t, h, seed=seed)
    xp = folded_projection(params, x)
    ys, gates = gru_recurrence(xp, params["w_hh"], params["b_hh"][2 * h:], h0, save=True)
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randn(b, t, h, generator=g).to(cuda), gates, ys, h0, params["w_hh"]


@pytest.mark.parametrize("b,t,h", [(1, 1001, 32), (16, 501, 32), (16, 501, 64), (8, 501, 128),
                                   (16, 501, 128)])
def test_gru_backward_kernel_matches_plain(cuda, b, t, h):
    """K8b against its plain version on the gates K8 saved, a random
    cotangent at every step: dxp, d_hn and dh0 each within 1e-4 of its
    scale (K8's gradient bar: a gate's derivative near saturation is small,
    and T reverse steps carry fp32 round-off in another order)."""
    args = _saved_case(cuda, b, t, h, seed=b + t + h)
    before = gru_backward.launches
    got = gru_backward(*args)
    torch.cuda.synchronize()
    assert gru_backward.launches == before + 1
    want = gru_backward_plain(*args)
    for name, a, w in zip(("dxp", "d_hn", "dh0"), got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=name)


@pytest.mark.parametrize("h", [7, 32, 64, 128])
def test_gru_kernel_saving_gates_leaves_ys_bit_equal(cuda, h):
    """K8 with the save flag writes the same ys bit for bit, and gates
    (r, z, n, h W_hn^T + b_hn) within 1e-5 of the plain version's."""
    from aec_tpu_torch.kernels.gru import folded_projection, gru_recurrence_plain

    params, x, h0 = _gru_case(cuda, 3, 101, h, seed=h)
    xp, b_hn = folded_projection(params, x), params["b_hh"][2 * h:]
    with torch.no_grad():
        ys = gru_recurrence(xp, params["w_hh"], b_hn, h0)
        ys_s, gates = gru_recurrence(xp, params["w_hh"], b_hn, h0, save=True)
        torch.cuda.synchronize()
        _, want = gru_recurrence_plain(xp, params["w_hh"], b_hn, h0, save=True)
    assert torch.equal(ys, ys_s)
    torch.testing.assert_close(gates, want, atol=1e-5, rtol=0)


def test_gru_route_at_batch_16_launches_k8_and_k8b(cuda):
    """gru_scan's own route at B = 16 x 501, H = 32 (a LittleNet train
    step's GRU): K8 once forward, K8b once backward, no plain loop; every
    gradient leaf within 1e-4 of its scale of the plain route's."""
    params, x, h0 = _gru_case(cuda, 16, 501, 32)
    leaves = [x, h0, *params.values()]
    for t in leaves:
        t.requires_grad_()
    cot = torch.randn(16, 501, 32, generator=torch.Generator().manual_seed(3)).to(cuda)
    before = gru_recurrence.launches, gru_backward.launches
    ys, _ = gru_scan(params, x, h0)
    got = torch.autograd.grad((ys * cot).sum(), leaves)
    torch.cuda.synchronize()
    assert (gru_recurrence.launches - before[0], gru_backward.launches - before[1]) == (1, 1)
    ys2, _ = gru_scan(params, x, h0, fused=False)
    want = torch.autograd.grad((ys2 * cot).sum(), leaves)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0)


def test_gru_kernels_follow_an_in_place_weight_change(cuda):
    """K8 and K8b pack W_hh once per weight tensor (``packed_lanes``): after
    an in-place change the next launches use the new weights, within K8's
    bar of the plain versions with the changed weights."""
    args = list(_saved_case(cuda, 2, 70, 32))
    params, x, h0 = _gru_case(cuda, 2, 70, 32)
    from aec_tpu_torch.kernels.gru import folded_projection, gru_recurrence_plain

    xp, b_hn = folded_projection(params, x), params["b_hh"][64:]
    gru_recurrence(xp, params["w_hh"], b_hn, h0)
    gru_backward(args[0], args[1], args[2], args[3], params["w_hh"])
    with torch.no_grad():
        params["w_hh"].mul_(0.8)
        ys, gates = gru_recurrence(xp, params["w_hh"], b_hn, h0, save=True)
        got = gru_backward(args[0], gates, ys, h0, params["w_hh"])
        torch.cuda.synchronize()
        want_ys, want_gates = gru_recurrence_plain(xp, params["w_hh"], b_hn, h0, save=True)
        want = gru_backward_plain(args[0], gates, ys, h0, params["w_hh"])
    torch.testing.assert_close(ys, want_ys, atol=1e-5, rtol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0)


def test_gru_backward_kernel_refuses_what_it_cannot_take(cuda):
    g_ys, gates, ys, h0, w_hh = _saved_case(cuda, 2, 9, 32)
    with pytest.raises(TypeError):
        gru_backward(g_ys.double(), gates, ys, h0, w_hh)
    with pytest.raises(ValueError, match="contiguous"):
        gru_backward(g_ys.transpose(0, 1).contiguous().transpose(0, 1), gates, ys, h0, w_hh)
    with pytest.raises(ValueError, match="CUDA"):  # no silent plain run
        gru_backward(g_ys, gates, ys, h0.cpu(), w_hh)
    with pytest.raises(ValueError, match="want"):
        gru_backward(g_ys, gates[..., :96].contiguous(), ys, h0, w_hh)
    # the wide path (H > 128) refuses what its plan cannot hold: K8b's
    # vectors of 37 rows at H = 512 past a CTA's shared memory, and at H =
    # 2048 more columns a CTA than its 16 warps
    wide = torch.zeros(37, 9, 512, device=cuda)
    with pytest.raises(ValueError, match="K8b's wide plan cannot hold B = 37, H = 512"):
        gru_backward(wide, torch.zeros(37, 9, 2048, device=cuda), wide, wide[:, 0].contiguous(),
                     torch.zeros(1536, 512, device=cuda))
    huge = torch.zeros(1, 9, 2048, device=cuda)
    with pytest.raises(ValueError, match="K8's wide plan cannot hold B = 1, H = 2048"):
        gru_recurrence(torch.zeros(1, 9, 6144, device=cuda), torch.zeros(6144, 2048, device=cuda),
                       torch.zeros(2048, device=cuda), huge[:, 0].contiguous())


@pytest.mark.parametrize("b,t,h", [(1, 1001, 129), (1, 1001, 512), (16, 501, 512),
                                   (8, 200, 300), (9, 200, 300)])
def test_gru_wide_kernel_matches_plain(cuda, b, t, h):
    """K8's wide path (H > 128) against its plain recurrence at a 16 s
    utterance (B = 1, T = 1001), the DCT-CNN's training batch (16 x 501) and
    both sides of the exchange's switch (8 rows in words with their step, 9
    by a counter): 1e-5 absolute; ys bit-equal with and without saving the
    gates, the gates within 1e-5 of the plain version's; one launch each,
    counted as the wide path's."""
    from aec_tpu_torch.kernels.gru import folded_projection, gru_recurrence_plain

    params, x, h0 = _gru_case(cuda, b, t, h, seed=b + t + h)
    xp, b_hn = folded_projection(params, x), params["b_hh"][2 * h:]
    before = gru_recurrence.launches, gru_recurrence.wide_launches
    with torch.no_grad():
        ys = gru_recurrence(xp, params["w_hh"], b_hn, h0)
        ys_s, gates = gru_recurrence(xp, params["w_hh"], b_hn, h0, save=True)
        torch.cuda.synchronize()
        want, want_gates = gru_recurrence_plain(xp, params["w_hh"], b_hn, h0, save=True)
    assert (gru_recurrence.launches - before[0], gru_recurrence.wide_launches - before[1]) == (2, 2)
    assert ys.shape == (b, t, h) and bool(torch.isfinite(ys).all())
    assert torch.equal(ys, ys_s)
    torch.testing.assert_close(ys, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(gates, want_gates, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t", [1, 63, 501])
@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("h", [129, 300, 512])
def test_gru_wide_backward_kernel_matches_plain(cuda, h, b, t):
    """K8b's wide path against its plain version on the gates K8's wide
    path saved, a random cotangent at every step: dxp, d_hn and dh0 each
    within 1e-4 of its scale (K8's gradient bar)."""
    args = _saved_case(cuda, b, t, h, seed=b + t + h)
    before = gru_backward.launches, gru_backward.wide_launches
    got = gru_backward(*args)
    torch.cuda.synchronize()
    assert (gru_backward.launches - before[0], gru_backward.wide_launches - before[1]) == (1, 1)
    want = gru_backward_plain(*args)
    for name, a, w in zip(("dxp", "d_hn", "dh0"), got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0, msg=name)


@pytest.mark.parametrize("b,t,h", [(16, 501, 512), (3, 100, 300), (1, 200, 129)])
def test_gru_wide_route_gradients_match_plain_route(cuda, b, t, h):
    """gru_scan's own route above H = 128 (the DCT-CNN's GRU at 16 x 501,
    H = 512, among them): the wide K8 once forward, the wide K8b once
    backward, no plain loop; every gradient leaf within 1e-4 of its scale of
    the plain route's."""
    params, x, h0 = _gru_case(cuda, b, t, h, i=512 if h == 512 else 64)
    leaves = [x, h0, *params.values()]
    for a in leaves:
        a.requires_grad_()
    cot = torch.randn(b, t, h, generator=torch.Generator().manual_seed(3)).to(cuda)
    before = gru_recurrence.wide_launches, gru_backward.wide_launches
    ys, _ = gru_scan(params, x, h0)
    got = torch.autograd.grad((ys * cot).sum(), leaves)
    torch.cuda.synchronize()
    assert (gru_recurrence.wide_launches - before[0], gru_backward.wide_launches - before[1]) \
        == (1, 1)
    ys2, _ = gru_scan(params, x, h0, fused=False)
    want = torch.autograd.grad((ys2 * cot).sum(), leaves)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0)


def test_gru_wide_kernels_follow_an_in_place_weight_change(cuda):
    """The wide path packs W_hh once per weight tensor and plan: after an
    in-place change the next launches use the new weights."""
    from aec_tpu_torch.kernels.gru import folded_projection, gru_recurrence_plain

    params, x, h0 = _gru_case(cuda, 2, 70, 300)
    xp, b_hn = folded_projection(params, x), params["b_hh"][600:]
    g = torch.randn(2, 70, 300, generator=torch.Generator().manual_seed(5)).to(cuda)
    ys, gates = gru_recurrence(xp, params["w_hh"], b_hn, h0, save=True)
    gru_backward(g, gates, ys, h0, params["w_hh"])
    with torch.no_grad():
        params["w_hh"].mul_(0.8)
        ys, gates = gru_recurrence(xp, params["w_hh"], b_hn, h0, save=True)
        got = gru_backward(g, gates, ys, h0, params["w_hh"])
        torch.cuda.synchronize()
        want_ys = gru_recurrence_plain(xp, params["w_hh"], b_hn, h0)
        want = gru_backward_plain(g, gates, ys, h0, params["w_hh"])
    torch.testing.assert_close(ys, want_ys, atol=1e-5, rtol=0)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0)


def test_batch_one_loss_backward_launches_gru_kernel(cuda, scene):
    """A batch-1 little_net_loss on the card (and its backward) goes through
    K8 (and K8b); the gradients match the same loss on the CPU route."""
    net = little_net_init(generator=torch.Generator().manual_seed(1))
    cpu_net = little_net_init(generator=torch.Generator().manual_seed(1), device="cpu")
    mic, far = scene(1, 80 * 256)
    near = 0.3 * mic
    erb = torch.from_numpy(erb_filterbank())
    before = gru_recurrence.launches, gru_backward.launches
    loss, _ = little_net_loss(net, mic.to(cuda), far.to(cuda), near.to(cuda), erb.to(cuda),
                              sqrt_eps=1e-12)
    loss.backward()
    assert (gru_recurrence.launches, gru_backward.launches) == (before[0] + 1, before[1] + 1)
    want, _ = little_net_loss(cpu_net, mic, far, near, erb, sqrt_eps=1e-12)
    want.backward()
    torch.testing.assert_close(loss.detach().cpu(), want.detach(), rtol=1e-4, atol=0)
    for (name, p), q in zip(net.named_parameters(), cpu_net.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-3 * float(q.grad.abs().max()),
                                   rtol=0, msg=lambda m, name=name: f"{name}: {m}")


def test_spectra_kernel_matches_k1_and_plain(cuda, scene):
    """K12 (spectra in) vs K1 (the same step with the analysis in the
    kernel) and vs its plain loop: K1's bar of 1e-3 of max|mic|."""
    cfg = KalmanConfig()
    far, mic = (t.to(cuda) for t in scene(5, 48 * 256))
    x_ri = ols.far_end_spectra(far, 256).contiguous()
    d_blocks = mic.reshape(5, -1, 256)
    before = kalman_filter_fused_batched.launches
    got = kalman_filter_fused_batched(cfg, x_ri, d_blocks)
    torch.cuda.synchronize()
    assert kalman_filter_fused_batched.launches == before + 1
    bar = 1e-3 * float(mic.abs().max())
    k1 = kalman_cancel_fused_batched(cfg, far, mic)["wav"].reshape(5, -1, 256)
    torch.testing.assert_close(got, k1, atol=bar, rtol=0)
    torch.testing.assert_close(got, kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks),
                               atol=bar, rtol=0)
    with pytest.raises(ValueError):
        kalman_filter_fused_batched(cfg, x_ri[:, :, :256].contiguous(), d_blocks)
    with pytest.raises(ValueError, match="shared memory"):
        kalman_filter_fused_batched(KalmanConfig(n_blocks=30), x_ri, d_blocks)


@pytest.mark.parametrize("batch", [1, 3, 256])
@pytest.mark.parametrize("n_blocks", [1, 4, 10, 16])
@pytest.mark.parametrize("block", [256, 160, 224])
def test_batched_kalman_steps_match_plain(cuda, scene, block, n_blocks, batch):
    """K1 and K12 against their plain loops at a batch of one, three and
    256, blocks 256 and 160 (the FFT step) and 224 = 2^5 7 (the dense step),
    1 to 16 partitions: 1e-3 of max|mic|; ``steps`` says which step ran."""
    cfg = KalmanConfig(n_blocks=n_blocks)
    far, mic = (t.to(cuda) for t in scene(batch, 24 * block + 37))
    bar = 1e-3 * float(mic.abs().max())
    step = "dense" if block == 224 else "fft"
    n = 24 * block
    x_ri = ols.far_end_spectra(far[:, :n].contiguous(), block).contiguous()
    d_blocks = mic[:, :n].reshape(batch, -1, block).contiguous()
    before = [dict(fn.steps) for fn in (kalman_cancel_fused_batched, kalman_filter_fused_batched)]
    with torch.no_grad():
        got = kalman_cancel_fused_batched(cfg, far, mic, block=block)["wav"]
        got12 = kalman_filter_fused_batched(cfg, x_ri, d_blocks, block=block)
        torch.cuda.synchronize()
        want = kalman_cancel_plain(cfg, far, mic, block=block)["wav"]
        want12 = kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks, block=block)
    for fn, was in zip((kalman_cancel_fused_batched, kalman_filter_fused_batched), before):
        assert fn.steps[step] == was[step] + 1
        assert sum(fn.steps.values()) == sum(was.values()) + 1
    torch.testing.assert_close(got, want, atol=bar, rtol=0)
    torch.testing.assert_close(got12, want12, atol=bar, rtol=0)


@pytest.mark.parametrize("batch", [1, 3, 256])
@pytest.mark.parametrize("n_blocks", [1, 4, 10, 16])
@pytest.mark.parametrize("block", [256, 160, 224])
def test_batched_nlms_steps_match_plain(cuda, scene, block, n_blocks, batch):
    """K5 against its plain loop at a batch of one, three and 256, blocks
    256 and 160 (the FFT step) and 224 = 2^5 7 (the dense step), 1 to 16
    partitions: K1's bar of 1e-3 of max|mic|; ``steps`` says which step
    ran."""
    cfg = NlmsConfig(n_blocks=n_blocks)
    far, mic = (t.to(cuda) for t in scene(batch, 24 * block + 37))
    step = "dense" if block == 224 else "fft"
    was = dict(nlms_cancel_fused_batched.steps)
    with torch.no_grad():
        got = nlms_cancel_fused_batched(cfg, far, mic, block=block)["wav"]
        torch.cuda.synchronize()
        want = nlms_cancel_plain(cfg, far, mic, block=block)["wav"]
    assert {k: v - was[k] for k, v in nlms_cancel_fused_batched.steps.items()} == {
        "fft": int(step == "fft"), "dense": int(step == "dense")}
    torch.testing.assert_close(got, want, atol=1e-3 * float(mic.abs().max()), rtol=0)


@pytest.mark.parametrize("n_blocks", [1, 4, 10, 16])
@pytest.mark.parametrize("block", [256, 160, 224])
@pytest.mark.parametrize("which", ["kalman", "nlms"])
def test_single_stream_steps_match_plain(cuda, scene, which, block, n_blocks):
    """K6 / K7 against their plain loops on one hop-fractional utterance at
    blocks 256 and 160 (the FFT route on one CTA) and 224 (the dense route
    on one cluster), 1 to 16 partitions: K1's bar of 1e-3 of max|mic|;
    ``steps`` says which route ran. K6 also against K1 as a batch of one."""
    cfg = KalmanConfig(n_blocks=n_blocks) if which == "kalman" else NlmsConfig(n_blocks=n_blocks)
    fused, plain = ((kalman_cancel_fused, kalman_cancel_plain) if which == "kalman"
                    else (nlms_cancel_fused, nlms_cancel_plain))
    far, mic = (t.to(cuda)[0].contiguous() for t in scene(1, 40 * block + 37))
    step = "dense" if block == 224 else "fft"
    bar = 1e-3 * float(mic.abs().max())
    was = dict(fused.steps)
    with torch.no_grad():
        got = fused(cfg, far, mic, block=block)["wav"]
        torch.cuda.synchronize()
        want = plain(cfg, far, mic, block=block)["wav"]
        assert {k: v - was[k] for k, v in fused.steps.items()} == {
            "fft": int(step == "fft"), "dense": int(step == "dense")}
        torch.testing.assert_close(got, want, atol=bar, rtol=0)
        if which == "kalman":
            k1 = kalman_cancel_fused_batched(cfg, far[None], mic[None], block=block)["wav"][0]
            torch.testing.assert_close(got, k1, atol=bar, rtol=0)


@pytest.mark.parametrize("block,step", [(256, "fft"), (160, "fft"), (96, "fft"), (45, "fft"),
                                        (224, "dense"), (112, "dense"), (1, "dense")])
def test_batched_kalman_step_selection(cuda, scene, block, step):
    """The wrappers take the FFT step for a block >= 2 whose only prime
    factors are 2, 3 and 5, the dense step for any other, and count it in
    ``steps``; either agrees with the plain loop."""
    cfg = KalmanConfig(n_blocks=3)
    far, mic = (t.to(cuda) for t in scene(2, 12 * block))
    x_ri = ols.far_end_spectra(far, block).contiguous()
    d_blocks = mic.reshape(2, -1, block)
    for fn, args in ((kalman_cancel_fused_batched, (far, mic)),
                     (kalman_filter_fused_batched, (x_ri, d_blocks))):
        was = dict(fn.steps)
        with torch.no_grad():
            out = fn(cfg, *args, block=block)
        torch.cuda.synchronize()
        assert {k: v - was[k] for k, v in fn.steps.items()} == {
            "fft": int(step == "fft"), "dense": int(step == "dense")}
        assert bool(torch.isfinite(out["wav"] if isinstance(out, dict) else out).all())
    want = kalman_cancel_plain(cfg, far, mic, block=block)["wav"]
    with torch.no_grad():
        got = kalman_cancel_fused_batched(cfg, far, mic, block=block)["wav"]
    torch.testing.assert_close(got, want, atol=1e-3 * float(mic.abs().max()), rtol=0)


def test_entry_points_default_to_the_card(cuda):
    """State and nets land on the card unless the caller asks for the CPU."""
    from aec_tpu_torch.kernels.serving import serving_init
    from aec_tpu_torch.pipeline.streaming import stream_init, stream_init_batched

    on_card = [*serving_init(2).values(), *stream_init()["stage1"].values(),
               stream_init()["gru_h"], *stream_init_batched(2)["stage1"].values(),
               *load_npz(ROBUST).parameters(), *little_net_init().parameters()]
    assert all(t.is_cuda for t in on_card)
    assert not any(t.is_cuda for t in serving_init(2, device="cpu").values())
    assert not any(p.is_cuda for p in load_npz(ROBUST, device="cpu").parameters())


# ---------------------------------------------------------------- every geometry

GEOMETRIES = [(4, 256), (16, 256), (10, 160)]


@pytest.mark.parametrize("n_blocks,hop", GEOMETRIES)
def test_stage1_kernels_take_every_geometry(cuda, scene, n_blocks, hop):
    """K1, K5, K6, K7 and K12 at other partition counts and a 160-sample
    block, each against its plain version at K1's bar (1e-3 of max|mic|)."""
    far, mic = (t.to(cuda) for t in scene(3, 40 * hop + 37))
    bar = 1e-3 * float(mic.abs().max())
    for cfg, batched, single, plain in (
            (KalmanConfig(n_blocks=n_blocks), kalman_cancel_fused_batched, kalman_cancel_fused,
             kalman_cancel_plain),
            (NlmsConfig(n_blocks=n_blocks), nlms_cancel_fused_batched, nlms_cancel_fused,
             nlms_cancel_plain)):
        want = plain(cfg, far, mic, block=hop)["wav"]
        before = (batched.launches, single.launches)
        got = batched(cfg, far, mic, block=hop)["wav"]
        one = single(cfg, far[1].contiguous(), mic[1].contiguous(), block=hop)["wav"]
        torch.cuda.synchronize()
        assert (batched.launches, single.launches) == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(got, want, atol=bar, rtol=0)
        torch.testing.assert_close(one, want[1], atol=bar, rtol=0)
    cfg = KalmanConfig(n_blocks=n_blocks)
    n = 40 * hop
    x_ri = ols.far_end_spectra(far[:, :n].contiguous(), hop).contiguous()
    d_blocks = mic[:, :n].reshape(3, -1, hop).contiguous()
    got = kalman_filter_fused_batched(cfg, x_ri, d_blocks, block=hop)
    torch.testing.assert_close(got, kalman_filter_fused_batched_plain(cfg, x_ri, d_blocks,
                                                                      block=hop),
                               atol=bar, rtol=0)


def test_kalman_cancel_at_four_partitions_runs_its_kernels(cuda, scene):
    far, mic = (t.to(cuda) for t in scene(2, 20 * 256))
    cfg = KalmanConfig(n_blocks=4)
    before = kalman_cancel_fused_batched.launches, kalman_cancel_fused.launches
    out = kalman_cancel(cfg, far, mic)["wav"]
    one = kalman_cancel(cfg, far[0].contiguous(), mic[0].contiguous())["wav"]
    assert (kalman_cancel_fused_batched.launches, kalman_cancel_fused.launches) == (
        before[0] + 1, before[1] + 1)
    bar = 1e-3 * float(mic.abs().max())
    want = kalman_cancel_plain(cfg, far, mic)["wav"]
    torch.testing.assert_close(out, want, atol=bar, rtol=0)
    torch.testing.assert_close(one, want[0], atol=bar, rtol=0)


@pytest.mark.parametrize("n_blocks,hop", GEOMETRIES)
def test_two_stage_and_serving_kernels_take_every_geometry(cuda, scene, n_blocks, hop):
    """K2, K4 and K3 (both filters) at other partition counts and the
    320 / 160 / 320 STFT, against their plain versions at the bars of the
    default geometry's tests."""
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain

    scfg = StftConfig(win_len=2 * hop, hop=hop, fft_len=2 * hop)
    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank(n_freqs=scfg.n_freqs)).to(cuda)
    far, mic = (t.to(cuda) for t in scene(4, 30 * hop))
    kcfg = KalmanConfig(n_blocks=n_blocks)
    with torch.no_grad():
        lin, fb = (t.reshape(4, -1, hop) for t in (mic, far))
        out, mask = little_net_apply_fused(net, lin, fb, erb, scfg)
        w_out, w_mask = little_net_apply_fused_plain(net, lin, fb, erb, scfg)
        torch.testing.assert_close(out, w_out, atol=1e-4 * float(w_out.abs().max()), rtol=0)
        torch.testing.assert_close(mask, w_mask, atol=1e-5, rtol=0)
        hops = dict(two_stage_fused.steps), dict(serving_step_fused.steps)
        got = two_stage_fused(net, far, mic, erb, kcfg=kcfg, scfg=scfg)
        want = two_stage_fused_plain(net, far, mic, erb, kcfg=kcfg, scfg=scfg)
        torch.testing.assert_close(got["linear_wav"], want["linear_wav"],
                                   atol=1e-3 * float(mic.abs().max()), rtol=0)
        torch.testing.assert_close(got["wav"], want["wav"],
                                   atol=1e-3 * float(want["wav"].abs().max()), rtol=0)
        torch.testing.assert_close(got["mask"], want["mask"], atol=1e-3, rtol=0)
        for stage1, cfg in (("kalman", kcfg), ("nlms", NlmsConfig(n_blocks=n_blocks))):
            ks, ps = (serving_init(4, kcfg=cfg, scfg=scfg, stage1=stage1, device=cuda)
                      for _ in range(2))
            for u in range(0, 12 * hop, 3 * hop):  # k = 3 hops per call
                fb3, mb3 = far[:, u:u + 3 * hop].contiguous(), mic[:, u:u + 3 * hop].contiguous()
                ks, o_k = serving_step_fused(net, ks, fb3, mb3, erb, cfg, scfg, stage1=stage1,
                                             normalize=True)
                ps, o_p = serving_step_plain(net, ps, fb3, mb3, erb, cfg, scfg, stage1=stage1,
                                             normalize=True)
                torch.testing.assert_close(o_k, o_p, atol=1e-3 * float(o_p.abs().max()), rtol=0)
            for key in ks:
                torch.testing.assert_close(ks[key], ps[key], rtol=0,
                                           atol=1e-3 * max(float(ps[key].abs().max()), 1e-9))
        assert two_stage_fused.steps == {**hops[0], "fft": hops[0]["fft"] + 1}
        assert serving_step_fused.steps == {**hops[1], "fft": hops[1]["fft"] + 8}


def test_two_stage_cancel_at_hop_160_runs_its_kernels(cuda, scene):
    """two_stage_cancel with StftConfig(320, 160, 320) on the card: the batch
    takes K1 + K2, quality="fast" K4, one utterance K6 + K2; within 0.1 dB
    tail ERLE of the CPU route."""
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.two_stage import two_stage_fused

    scfg = StftConfig(win_len=320, hop=160, fft_len=320)
    erb_np = erb_filterbank(n_freqs=scfg.n_freqs)
    net = load_npz(ROBUST).to(cuda)
    far, mic = scene(2, 100 * 160)
    fd, md = far.to(cuda), mic.to(cuda)
    kernels = (kalman_cancel_fused_batched, little_net_apply_fused, two_stage_fused,
               kalman_cancel_fused)
    before = [k.launches for k in kernels]
    with torch.no_grad():
        batch = two_stage_cancel(net, fd, md, erb_np, scfg=scfg)
        fast = two_stage_cancel(net, fd, md, erb_np, scfg=scfg, quality="fast")
        one = two_stage_cancel(net, fd[0].contiguous(), md[0].contiguous(), erb_np, scfg=scfg)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 2, 1, 1]
    want = two_stage_cancel(load_npz(ROBUST, device="cpu"), far, mic, erb_np, scfg=scfg)

    def tail_db(m, e):
        t = slice(m.shape[-1] // 2, None)
        return 10 * np.log10(np.sum(m[t] ** 2) / (np.sum(e[t] ** 2) + 1e-12))

    for got, rows in ((batch, (0, 1)), (fast, (0, 1)), (one, (0,))):
        for i in rows:
            g = got["wav"] if got["wav"].ndim == 1 else got["wav"][i]
            assert abs(tail_db(mic[i].numpy(), g.cpu().numpy())
                       - tail_db(mic[i].numpy(), want["wav"][i].numpy())) <= 0.1


def _largest_l(run):
    """The largest partition count ``run`` accepts; the first refusal must be
    for shared memory."""
    for n_blocks in range(1, 257):
        try:
            run(n_blocks)
        except ValueError as e:
            assert "shared memory" in str(e) and n_blocks > 1, str(e)
            return n_blocks - 1
    raise AssertionError("no partition count up to 256 was refused")


def _at_partitions(kernel, n_blocks, hop, net, erb, far, mic, plain=False):
    """``kernel`` (its plain version if ``plain``) at ``n_blocks`` partitions
    and block ``hop``: -> a dict of outputs."""
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.serving import serving_init, serving_step_fused, serving_step_plain
    from aec_tpu_torch.kernels.two_stage import two_stage_fused, two_stage_fused_plain

    scfg = StftConfig(win_len=2 * hop, hop=hop, fft_len=2 * hop)
    kc, nc = KalmanConfig(n_blocks=n_blocks), NlmsConfig(n_blocks=n_blocks)
    if kernel in ("K1", "K5", "K6", "K7"):
        cfg = kc if kernel in ("K1", "K6") else nc
        fn = {"K1": (kalman_cancel_fused_batched, kalman_cancel_plain),
              "K5": (nlms_cancel_fused_batched, nlms_cancel_plain),
              "K6": (kalman_cancel_fused, kalman_cancel_plain),
              "K7": (nlms_cancel_fused, nlms_cancel_plain)}[kernel][plain]
        if kernel in ("K6", "K7"):
            far, mic = far[0].contiguous(), mic[0].contiguous()
        return {"wav": fn(cfg, far, mic, block=hop)["wav"]}
    if kernel == "K12":
        fn = kalman_filter_fused_batched_plain if plain else kalman_filter_fused_batched
        n = far.shape[-1] // hop * hop
        return {"wav": fn(kc, ols.far_end_spectra(far[:, :n].contiguous(), hop).contiguous(),
                          mic[:, :n].reshape(far.shape[0], -1, hop).contiguous(), block=hop)}
    if kernel == "K4":
        fn = two_stage_fused_plain if plain else two_stage_fused
        return fn(net, far, mic, erb, kcfg=kc, scfg=scfg)
    stage1 = kernel.split("-")[1]  # K3-kalman, K3-nlms: 3 calls of 2 hops
    cfg = kc if stage1 == "kalman" else nc
    step = serving_step_plain if plain else serving_step_fused
    st = serving_init(far.shape[0], kcfg=cfg, scfg=scfg, stage1=stage1, device=far.device)
    outs = []
    for u in range(0, min(6, far.shape[-1] // hop) * hop, 2 * hop):
        st, o = step(net, st, far[:, u:u + 2 * hop].contiguous(), mic[:, u:u + 2 * hop].contiguous(),
                     erb, cfg, scfg, stage1=stage1)
        outs.append(o)
    return {"out": torch.cat(outs, -1), **{f"state {k}": v for k, v in st.items()}}


@pytest.mark.parametrize("hop", [256, 160])
@pytest.mark.parametrize("kernel", ["K1", "K12", "K5", "K6", "K7", "K4", "K3-kalman", "K3-nlms"])
def test_kernels_at_their_largest_partition_count(cuda, scene, kernel, hop):
    """Every kernel whose shared-memory layout grows with the partition
    count, at the largest L its wrapper accepts (raised from 1 on a
    two-block input until the wrapper refuses for shared memory), against
    its plain version at the geometry tests' bars: stage-1 outputs at 1e-3
    of max|mic|, K4's wav at 1e-3 of its scale and mask at 1e-3, K3's
    outputs and state leaves at 1e-3 of each one's scale."""
    from aec_tpu_torch.dsp.stft import StftConfig

    net = load_npz(ROBUST).to(cuda)
    erb = torch.from_numpy(erb_filterbank(n_freqs=StftConfig(2 * hop, hop, 2 * hop).n_freqs))
    erb = erb.to(cuda)
    far, mic = (t.to(cuda) for t in scene(2, 60 * hop))
    tiny = far[:, :2 * hop].contiguous(), mic[:, :2 * hop].contiguous()
    with torch.no_grad():
        n_max = _largest_l(lambda n: _at_partitions(kernel, n, hop, net, erb, *tiny))
        got = _at_partitions(kernel, n_max, hop, net, erb, far, mic)
        want = _at_partitions(kernel, n_max, hop, net, erb, far, mic, plain=True)
    # the FFT layouts' largest L at blocks 256 and 160, each at or above what
    # the kernel's dense layout held (K6 / K7's cluster: 18 / 46, 18 / 47)
    floor = {"K1": (24, 39), "K12": (24, 39), "K5": (27, 43), "K6": (29, 56), "K7": (36, 69),
             "K4": (23, 38), "K3-kalman": (23, 38), "K3-nlms": (26, 43)}[kernel]
    assert n_max >= floor[hop != 256]
    for key, w in want.items():
        if key == "mask":
            atol = 1e-3
        elif kernel.startswith("K3") or key == "wav" and kernel == "K4":
            atol = 1e-3 * max(float(w.abs().max()), 1e-9)
        else:
            atol = 1e-3 * float(mic.abs().max())
        torch.testing.assert_close(got[key], w, atol=atol, rtol=0,
                                   msg=lambda m, key=key: f"{kernel} L={n_max} {key}: {m}")


@pytest.mark.parametrize("seed", [1, 2])
def test_stage2_mask_against_fp64(cuda, scene, seed):
    """K2's mask on full-scale noise through an untrained net, where the
    mask's fp32 round-off is largest (each fp32 evaluation up to ~1.2e-5
    from fp64 there): within 5e-5 of the plain version evaluated in fp64
    and of the plain fp32 version, while TF32 products, the lower-precision
    control, land more than 1e-3 off, so the bar tells fp32 from lower
    precision."""
    import copy

    net = little_net_init(generator=torch.Generator().manual_seed(seed))
    erb = torch.from_numpy(erb_filterbank()).to(cuda)
    far, mic = (t.to(cuda) for t in scene(4, 40 * 256))
    with torch.no_grad():
        lin = kalman_cancel_plain(KalmanConfig(), far, mic)["wav"].reshape(4, -1, 256)
        fb = far.reshape(4, -1, 256)
        _, m64 = little_net_apply_fused_plain(copy.deepcopy(net).double(), lin.double(),
                                              fb.double(), erb.double())
        _, mask = little_net_apply_fused(net, lin, fb, erb)
        _, m32 = little_net_apply_fused_plain(net, lin, fb, erb)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, m_tf32 = little_net_apply_fused_plain(net, lin, fb, erb)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(mask.double(), m64, atol=5e-5, rtol=0)
    torch.testing.assert_close(mask, m32, atol=5e-5, rtol=0)
    assert float((m_tf32.double() - m64).abs().max()) > 1e-3


# ---------------------------------------------------------------- K9 and DCCRN

def _clstm_case(cuda, b, t, width=2048, seed=0):
    from aec_tpu_torch.ops.lstm import complex_lstm_init

    g = torch.Generator().manual_seed(seed)
    params = complex_lstm_init(width, width, generator=g, device=cuda)
    r, i = (torch.randn(b, t, width // 2, generator=g).to(cuda) for _ in range(2))
    return params, r, i


@pytest.mark.parametrize("b", [1, 8, 16])
def test_lstm_kernel_matches_plain(cuda, b):
    """K9 at DCCRN's full width (I = H = 1024 per part) over T = 513 frames
    vs its plain version, at B = 1 (W_hh all on chip), 8 and 16 (the largest
    B routed: part of W_hh read from L2 each step): h in [-1, 1], fp32 in
    another summation order -> 1e-5 absolute."""
    from aec_tpu_torch.kernels.lstm import (
        complex_lstm_scan_fused,
        complex_lstm_scan_fused_plain,
        grouped_lstm_recurrence,
    )

    params, r, i = _clstm_case(cuda, b, 513)
    before = grouped_lstm_recurrence.launches
    with torch.no_grad():
        got = complex_lstm_scan_fused(params, r, i)
        torch.cuda.synchronize()
        want = complex_lstm_scan_fused_plain(params, r, i)
    assert grouped_lstm_recurrence.launches == before + 1
    for a, w in zip(got, want):
        assert a.shape == (b, 513, 1024)
        torch.testing.assert_close(a, w, atol=1e-5, rtol=0)


def test_complex_lstm_routes_to_k9(cuda):
    """On a CUDA tensor complex_lstm_scan takes K9 at B <= 16 and T >= 64,
    as JAX routes its TPU kernel, and the plain loop otherwise."""
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.ops.lstm import complex_lstm_scan

    for b, t, want in ((1, 64, 1), (16, 70, 1), (1, 63, 0), (17, 64, 0)):
        params, r, i = _clstm_case(cuda, b, t, width=64)
        before = grouped_lstm_recurrence.launches
        with torch.no_grad():
            complex_lstm_scan(params, r, i)
        assert grouped_lstm_recurrence.launches - before == want, (b, t)


def test_lstm_kernel_gradients_equal_plain_route(cuda):
    """The Function's backward (K9b on the gates K9 saved, and the products)
    computes the plain route's gradients from the same inputs and
    cotangents, to 1e-5 of each leaf's scale."""
    from aec_tpu_torch.ops.lstm import complex_lstm_scan

    params, r, i = _clstm_case(cuda, 1, 80, width=128)
    leaves = [r, i] + [params[g][k] for g in ("real", "imag")
                       for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    for t in leaves:
        t.requires_grad_()
    cot = [torch.randn(1, 80, 64, device=cuda) for _ in range(2)]
    grads = {}
    for fused in (None, False):
        out = complex_lstm_scan(params, r, i, fused=fused)
        grads[fused] = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), leaves)
    for a, w in zip(grads[None], grads[False]):
        torch.testing.assert_close(a, w, atol=1e-5 * float(w.abs().max()), rtol=0)


def test_lstm_packed_weights_follow_in_place_changes(cuda):
    """K9 packs W_hh into its on-chip layout once per weight tensor and
    caches it; an in-place change to a group's W_hh (an optimizer step, a
    ``copy_``) makes the next call pack again: every call equals the plain
    route on the weights it was given, and a repeated call reuses the
    packed tensor."""
    from aec_tpu_torch.kernels.lstm import (
        card_plan,
        complex_lstm_scan_fused,
        complex_lstm_scan_fused_plain,
        packed_weights,
    )

    params, r, i = _clstm_case(cuda, 1, 96, width=512)
    groups = [params[g]["w_hh"] for g in ("real", "imag")]
    plan = card_plan(2, 2, 256, cuda)
    with torch.no_grad():
        first = complex_lstm_scan_fused(params, r, i)
        assert packed_weights(groups, plan) is packed_weights(groups, plan)
        for a, w in zip(first, complex_lstm_scan_fused_plain(params, r, i)):
            torch.testing.assert_close(a, w, atol=1e-5, rtol=0)
        params["imag"]["w_hh"].mul_(-0.5)
        second = complex_lstm_scan_fused(params, r, i)
        for a, w, f in zip(second, complex_lstm_scan_fused_plain(params, r, i), first):
            torch.testing.assert_close(a, w, atol=1e-5, rtol=0)
            assert float((a - f).abs().max()) > 1e-3


def _bwd_case(cuda, g, b, f, t, h, seed=0):
    """K9b's inputs in its (G, B, T, F, .) layout: the gates the plain
    saving recurrence gives over G x B F rows (W_hh at torch's init scale,
    projections of unit scale), a random cotangent, W_hh (G, 4H, H)."""
    from aec_tpu_torch.ops.lstm import grouped_lstm_recurrence_plain

    gen = torch.Generator().manual_seed(seed)
    w = ((torch.rand(g, 4 * h, h, generator=gen) * 2 - 1) / h ** 0.5).to(cuda)
    xp = torch.randn(g, b * f, t, 4 * h, generator=gen).to(cuda)
    with torch.no_grad():
        _, saved = grouped_lstm_recurrence_plain(xp, w, save=True)
    lay = lambda a: a.reshape(g, b, f, t, -1).transpose(2, 3).contiguous()  # noqa: E731
    g_ys = torch.randn(g, b * f, t, h, generator=gen).to(cuda)
    return lay(g_ys), lay(saved), w


@pytest.mark.parametrize("g,b,f,t,h,mode", [
    (1, 1, 7, 30, 16, "local"), (1, 16, 161, 801, 96, "local"),     # FullSubNet's sub band
    (2, 4, 1, 40, 256, "cluster"), (2, 32, 1, 501, 1024, "split"),  # DCCRN's grouped LSTM
    (1, 16, 1, 801, 256, "cluster"), (1, 2, 3, 20, 300, "cluster")])  # the full band; F rows
def test_lstm_backward_kernel_matches_plain(cuda, g, b, f, t, h, mode):
    """K9b against its plain version at a small and a full shape of each
    plan (DCCRN's training shape, B = 16: 2 groups x 32 rows x 501 steps
    at H = 1024; FullSubNet's sub band at B = 16: 16 x 161 rows x 801
    steps at H = 96, and its full band, 16 rows at H = 256): an fp32
    reverse recursion summed in another order -> 1e-5 of dxp's scale."""
    from aec_tpu_torch.kernels.lstm_bwd import card_plan, lstm_backward, lstm_backward_plain

    g_ys, saved, w = _bwd_case(cuda, g, b, f, t, h)
    before = lstm_backward.launches
    with torch.no_grad():
        got = lstm_backward(g_ys, saved, w)
        torch.cuda.synchronize()
        want = lstm_backward_plain(g_ys, saved, w)
    assert lstm_backward.launches == before + 1
    assert got.shape == (g, b, t, f, 4 * h)
    assert card_plan(g, b * f, h, cuda).mode == mode
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


@pytest.mark.parametrize("g,b,f,t,h,mode,what", [
    (2, 5, 1, 30, 1024, "split", "5 rows: one pass of 16 rows, 11 of them empty"),
    (2, 18, 1, 12, 1024, "split", "18 rows: two passes of 16"),
    (1, 5, 1, 20, 1200, "grid", "H = 1200, past the split plan: blocks of one row"),
    (2, 3, 1, 20, 2048, "grid", "H = 2048, some of W from L2"),
    (1, 3, 1, 20, 256, "cluster", "3 rows over a cluster of 16"),
    (1, 4, 161, 9, 96, "local", "sub-band runs of 5 rows crossing sequences of 161"),
    (2, 4, 1, 1, 1024, "split", "T = 1"),
    (1, 16, 1, 1, 256, "cluster", "T = 1"),
    (1, 3, 7, 1, 96, "local", "T = 1"),
    (2, 4, 1, 20, 1000, "split", "H = 1000 over 63 chunks of 16 units"),
    (1, 4, 1, 20, 300, "cluster", "H = 300 over 15 chunks of 20 units"),
    (1, 4, 1, 20, 200, "cluster", "H = 200 over 13 chunks of 16 units, the last padded"),
    (1, 3, 1, 20, 30, "local", "H = 30, padded to 32 with zero units")])
def test_lstm_backward_kernel_at_edge_shapes(cuda, g, b, f, t, h, mode, what):
    """K9b against its plain version where its plans meet their edges,
    within 1e-5 of dxp's scale."""
    from aec_tpu_torch.kernels.lstm_bwd import card_plan, lstm_backward, lstm_backward_plain

    g_ys, saved, w = _bwd_case(cuda, g, b, f, t, h)
    with torch.no_grad():
        got = lstm_backward(g_ys, saved, w)
        torch.cuda.synchronize()
        want = lstm_backward_plain(g_ys, saved, w)
    assert card_plan(g, b * f, h, cuda).mode == mode, what
    assert got.shape == (g, b, t, f, 4 * h)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0, msg=what)


@pytest.mark.parametrize("mode", ["local", "cluster", "grid", "split"])
@pytest.mark.parametrize("g,b,f,t,h", [(2, 3, 1, 20, 32), (1, 3, 5, 9, 64)])
def test_lstm_backward_kernel_takes_every_plan(cuda, mode, g, b, f, t, h):
    """Each exchange (``_plan(mode, ...)``) at small shapes, the kernel
    against its plain version within 1e-5 of dxp's scale."""
    from aec_tpu_torch.kernels import lstm_bwd as kb

    g_ys, saved, w = _bwd_case(cuda, g, b, f, t, h)
    props = torch.cuda.get_device_properties(cuda)
    plan = kb._plan(mode, g, b * f, h, props.multi_processor_count,
                    props.shared_memory_per_block_optin)
    with torch.no_grad():
        got = kb.launch(plan, g_ys, saved, list(w))
        torch.cuda.synchronize()
        want = kb.lstm_backward_plain(g_ys, saved, w)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


def test_lstm_backward_kernel_refuses_what_it_cannot_take(cuda):
    """A CUDA call K9b cannot take raises and never runs the plain loop:
    another dtype, a strided cotangent, mismatched shapes, the CPU and the
    card mixed."""
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward

    g_ys, saved, w = _bwd_case(cuda, 2, 2, 1, 8, 16)
    before = lstm_backward.launches
    with pytest.raises(TypeError):
        lstm_backward(g_ys.double(), saved.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_backward(g_ys.transpose(1, 2).contiguous().transpose(1, 2), saved, w)
    with pytest.raises(ValueError, match="want"):
        lstm_backward(g_ys, saved[..., :-1].contiguous(), w)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_backward(g_ys, saved, w.cpu())
    assert lstm_backward.launches == before


@pytest.mark.parametrize("b,width", [(1, 128), (16, 2048)])
def test_lstm_kernel_saving_gates_leaves_ys_bit_equal(cuda, b, width):
    """K9 with its gates saved gives the same ys bit for bit, at a narrow
    net and DCCRN's width at B = 16 (R = 32 rows); the saved gates and c
    are the plain saving recurrence's within 1e-5."""
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence, grouped_projection, stacked
    from aec_tpu_torch.ops.lstm import grouped_lstm_recurrence_plain

    params, r, i = _clstm_case(cuda, b, 80, width=width)
    with torch.no_grad():
        xp = grouped_projection(params, torch.cat([r, i], 0)).contiguous()
        w = stacked(params, "w_hh")
        ys = grouped_lstm_recurrence(xp, w)
        ys_s, saved = grouped_lstm_recurrence(xp, w, save=True)
        torch.cuda.synchronize()
        _, want = grouped_lstm_recurrence_plain(xp, w, save=True)
    assert torch.equal(ys, ys_s)
    torch.testing.assert_close(saved, want, atol=1e-5, rtol=0)


def test_lstm_route_at_batch_16_launches_k9_and_k9b(cuda):
    """complex_lstm_scan's route at B = 16 (K9 saving its gates, then K9b
    and the products) against the plain route differentiated by autograd:
    both inputs and the 8 parameters within 1e-4 of each leaf's scale (the
    zoo's gradient bar); launches K9 / K9b 1 / 1, the plain route 0 / 0."""
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward
    from aec_tpu_torch.ops.lstm import complex_lstm_scan

    params, r, i = _clstm_case(cuda, 16, 70, width=256)
    leaves = [r, i] + [params[g][k] for g in ("real", "imag")
                       for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    for t in leaves:
        t.requires_grad_()
    cot = [torch.randn(16, 70, 128, device=cuda) for _ in range(2)]
    grads, counts = {}, {}
    for fused in (None, False):
        before = grouped_lstm_recurrence.launches, lstm_backward.launches
        out = complex_lstm_scan(params, r, i, fused=fused)
        grads[fused] = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), leaves)
        counts[fused] = (grouped_lstm_recurrence.launches - before[0],
                         lstm_backward.launches - before[1])
    assert counts == {None: (1, 1), False: (0, 0)}
    for a, w in zip(grads[None], grads[False]):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0)


def test_dccrn_enhancer_runs_k1_and_k9(cuda, scene, tmp_path):
    """cli/infer's DCCRN enhancer at DccrnConfig() on the card, one
    utterance: one K1 launch (Kalman stage 1 on the (1, n) batch) and two
    K9 launches (one per complex-LSTM layer); the wav within 1e-3 of scale
    of the CPU route (K1's round-off enters DCCRN's input; cuDNN's TF32
    pinned off)."""
    from aec_tpu_torch.cli.infer import _make_enhancer
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.models.dccrn import dccrn_init
    from aec_tpu_torch.train import checkpoints

    torch.backends.cudnn.allow_tf32 = False
    params, state = dccrn_init(generator=torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "dccrn.npz")
    checkpoints.save(path, {"params": params, "model_state": state})
    far, mic = scene(1, 200 * 256)
    enhance, _ = _make_enhancer("dccrn", path, "kalman", StftConfig(), device=cuda)
    before = kalman_cancel_fused_batched.launches, grouped_lstm_recurrence.launches
    got = enhance(far.to(cuda), mic.to(cuda))
    torch.cuda.synchronize()
    assert (kalman_cancel_fused_batched.launches - before[0],
            grouped_lstm_recurrence.launches - before[1]) == (1, 2)
    enhance_cpu, _ = _make_enhancer("dccrn", path, "kalman", StftConfig(), device="cpu")
    want = enhance_cpu(far, mic)
    assert got.shape == want.shape == mic.shape
    torch.testing.assert_close(got.cpu(), want, atol=1e-3 * float(want.abs().max()), rtol=0)


def _fsn_case(cuda, fb, sb, b, t, seed=0):
    from aec_tpu_torch.models.fullsubnet import FullSubNetConfig, fullsubnet_init

    g = torch.Generator().manual_seed(seed)
    params = fullsubnet_init(FullSubNetConfig(fb_hidden=fb, sb_hidden=sb), generator=g,
                             device=cuda)
    xp_fb = (0.3 * torch.randn(b, t, 4 * fb, generator=g)).to(cuda)
    xp_sb = (0.3 * torch.randn(b, t, 161, 4 * sb, generator=g)).to(cuda)
    return params, xp_fb, xp_sb


@pytest.mark.parametrize("fb,sb,b,t", [(32, 16, 1, 40), (256, 96, 1, 120), (256, 96, 4, 60),
                                       (40, 24, 3, 30), (512, 96, 1, 60), (256, 96, 16, 30),
                                       (30, 18, 2, 20)])
def test_fullsubnet_kernel_matches_plain(cuda, fb, sb, b, t):
    """K11 against its plain joint loop at narrow and FullSubNetConfig()
    widths, B = 1, 4 and 16 (23 rows a consumer CTA), H_fb 512 (the producer
    reads the rest of W_hh_fb from L2 each step) and H_fb 30 (padded to 32
    by the wrapper): h in [-1, 1], an fp32 recursion summed in another order
    -> 1e-5 absolute."""
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.models.fullsubnet import _joint_scan_hs

    params, xp_fb, xp_sb = _fsn_case(cuda, fb, sb, b, t)
    before = joint_recurrence.launches
    with torch.no_grad():
        got = joint_recurrence(params, xp_fb, xp_sb)
        torch.cuda.synchronize()
        want = _joint_scan_hs(params, xp_fb, xp_sb)
    assert joint_recurrence.launches == before + 1
    assert got.shape == (b, t, 161, sb)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_fullsubnet_plan_is_the_python_mirror(cuda):
    """The launch plan csrc/fullsubnet.cu makes on this card (aec_fsn_plan)
    equals kernels/fullsubnet.py fsn_plan given the clusters the card places
    and its shared memory, at the test shapes, FullSubNetConfig()'s B = 1,
    4 and 16, and a shape it refuses."""
    from aec_tpu_torch.kernels.fullsubnet import PLAN_FIELDS, card_plan, fsn_plan

    clusters = card_plan(4, 161, 256, 96, cuda)["clusters"]  # 644 rows fill every cluster
    cap = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    for fb, sb, b in [(32, 16, 1), (256, 96, 1), (256, 96, 4), (40, 24, 3), (512, 96, 1),
                      (256, 96, 16), (256, 96, 64), (512, 112, 16)]:
        want = fsn_plan(b, 161, fb, sb, clusters=clusters, smem_cap=cap)
        assert card_plan(b, 161, fb, sb, cuda) == {k: want[k] for k in PLAN_FIELDS}, (fb, sb, b)


def test_fullsubnet_kernel_refuses_what_it_cannot_take(cuda):
    """A CUDA call K11 cannot take raises and never runs the plain loop:
    B = 64 rows of h, c and pre-activations per CTA beyond shared memory;
    another dtype; a strided input."""
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence

    params, xp_fb, xp_sb = _fsn_case(cuda, 256, 96, 64, 4)
    before = joint_recurrence.launches
    with pytest.raises(ValueError, match="shared memory"):
        joint_recurrence(params, xp_fb, xp_sb)
    params, xp_fb, xp_sb = _fsn_case(cuda, 32, 16, 1, 8)
    with pytest.raises(TypeError):
        joint_recurrence(params, xp_fb.double(), xp_sb.double())
    with pytest.raises(ValueError, match="contiguous"):
        joint_recurrence(params, xp_fb[:, ::2], xp_sb[:, ::2])
    assert joint_recurrence.launches == before


def test_fullsubnet_routes_and_gradients(cuda):
    """fullsubnet_masks on a CUDA tensor runs K11 once (joint_kernel=False
    none); the Function's gradients (K9b over each band on the gates K11
    saved) equal the plain route's to 1e-5 of each leaf's scale."""
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.models.fullsubnet import FullSubNetConfig, fullsubnet_masks

    cfg = FullSubNetConfig(fb_hidden=32, sb_hidden=16)
    params, _, _ = _fsn_case(cuda, 32, 16, 1, 1)
    g = torch.Generator().manual_seed(3)
    mic, ref = (torch.rand(2, 50, 161, generator=g).to(cuda) for _ in range(2))
    leaves = [params[a][k] for a in ("fb_lstm", "sb_lstm")
              for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    leaves += [params[a][k] for a in ("fb_out", "sb_out") for k in ("w", "b")]
    for t in leaves:
        t.requires_grad_()
    grads, counts = {}, {}
    for jk in (None, False):
        before = joint_recurrence.launches
        near, echo = fullsubnet_masks(params, mic, ref, cfg, joint_kernel=jk)
        counts[jk] = joint_recurrence.launches - before
        grads[jk] = torch.autograd.grad((near * near).sum() + (echo * mic).sum(), leaves)
    assert counts == {None: 1, False: 0}
    for a, w in zip(grads[None], grads[False]):
        torch.testing.assert_close(a, w, atol=1e-5 * float(w.abs().max()), rtol=0)


@pytest.mark.parametrize("fb,sb,b,t", [(32, 16, 1, 40), (256, 96, 16, 60), (30, 18, 2, 20)])
def test_fullsubnet_kernel_saving_leaves_ys_bit_equal(cuda, fb, sb, b, t):
    """K11 with what the backward reads saved gives the same sub-band
    sequence bit for bit (at a narrow net, FullSubNetConfig()'s widths at B =
    16, and H_fb 30, padded to 32 by the wrapper); what it saves is the
    plain saving loop's within 1e-5."""
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.models.fullsubnet import _joint_scan_hs

    params, xp_fb, xp_sb = _fsn_case(cuda, fb, sb, b, t)
    with torch.no_grad():
        ys = joint_recurrence(params, xp_fb, xp_sb)
        got = joint_recurrence(params, xp_fb, xp_sb, save=True)
        torch.cuda.synchronize()
        want = _joint_scan_hs(params, xp_fb, xp_sb, save=True)
    assert torch.equal(ys, got[0])
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, atol=1e-5 * max(1.0, float(w.abs().max())), rtol=0)


def test_fullsubnet_route_at_batch_4_launches_k11_and_k9b_twice(cuda):
    """fsn_joint_fused at FullSubNetConfig()'s widths, B = 4, T = 60: K11
    saving, then K9b over the sub band and over the full band, against the
    plain joint loop differentiated by autograd: both projections and the 5
    weights within 1e-4 of each leaf's scale; launches K11 / K9b 1 / 2."""
    from aec_tpu_torch.kernels.fullsubnet import _LEAVES, fsn_joint_fused, joint_recurrence
    from aec_tpu_torch.kernels.lstm_bwd import lstm_backward
    from aec_tpu_torch.models.fullsubnet import _joint_scan_hs

    params, xp_fb, xp_sb = _fsn_case(cuda, 256, 96, 4, 60)
    leaves = [xp_fb, xp_sb] + [params[a][k] for a, k in _LEAVES]
    for v in leaves:
        v.requires_grad_()
    cot = torch.randn(4, 60, 161, 96, device=cuda)
    before = joint_recurrence.launches, lstm_backward.launches
    got = torch.autograd.grad(fsn_joint_fused(params, xp_fb, xp_sb), leaves, cot)
    assert (joint_recurrence.launches - before[0], lstm_backward.launches - before[1]) == (1, 2)
    want = torch.autograd.grad(_joint_scan_hs(params, xp_fb, xp_sb), leaves, cot)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4 * float(w.abs().max()), rtol=0)


def _int8_case(cuda, h, b, t, seed=0):
    from aec_tpu_torch.ops.lstm import lstm_init, quantize_rows_int8

    g = torch.Generator().manual_seed(seed)
    params = lstm_init(h, h, generator=g, device=cuda)
    x = torch.randn(b, t, h, generator=g).to(cuda)
    xp = x @ params["w_ih"].T + params["b_ih"]
    w_q, scale = quantize_rows_int8(params["w_hh"])
    return params, x, (xp, w_q, scale / 127.0, params["b_hh"])


@pytest.mark.parametrize("h,b,t", [(128, 1, 40), (1024, 1, 64), (4096, 1, 64), (1024, 3, 32),
                                   (100, 2, 20), (4096, 9, 8), (4096, 3, 16), (4096, 8, 16),
                                   (1000, 3, 24), (9000, 1, 6)])
def test_int8_kernel_matches_plain(cuda, h, b, t):
    """K10 against the plain int8 loop, ATT-CCRN's H = 4096 included (its
    codes in registers, shared memory and L2), B > 1, an H that is no
    multiple of 16 and one too wide for codes in registers (H = 9000: 72
    units a CTA), from zero and from a given state.
    The kernel repeats the loop's operations in its order, so a code of h
    flips only if a transcendental differs by an ulp near a half; a flip
    moves one h_q by 1/127: 1e-2 absolute."""
    from aec_tpu_torch.kernels.lstm_int8 import lstm_int8_recurrence
    from aec_tpu_torch.ops.lstm import lstm_int8_recurrence_plain

    _, _, args = _int8_case(cuda, h, b, t)
    g = torch.Generator().manual_seed(7)
    for h0, c0 in ((torch.zeros(b, h, device=cuda), torch.zeros(b, h, device=cuda)),
                   ((0.5 * torch.randn(b, h, generator=g)).to(cuda),
                    torch.randn(b, h, generator=g).to(cuda))):
        before = lstm_int8_recurrence.launches
        ys, (h_t, c_t) = lstm_int8_recurrence(*args, h0, c0)
        torch.cuda.synchronize()
        assert lstm_int8_recurrence.launches == before + 1
        want, (hw, cw) = lstm_int8_recurrence_plain(*args, h0, c0)
        assert ys.shape == (b, t, h)
        torch.testing.assert_close(ys, want, atol=1e-2, rtol=0)
        torch.testing.assert_close(c_t, cw, atol=1e-2, rtol=0)
        assert torch.equal(h_t, ys[:, -1])


def test_int8_prepared_codes_follow_in_place_changes(cuda):
    """K10's codes (``lstm_scan``'s quantization of W_hh) and their on-chip
    layout are built once per tensor and cached; an in-place change to W_hh
    or to the codes makes the next call build them again: every call equals
    the plain int8 loop on the weights it was given (1e-2, one flipped code
    of h), and a repeated call reuses the codes."""
    from aec_tpu_torch.kernels.lstm_int8 import lstm_int8_recurrence, quantized
    from aec_tpu_torch.ops.lstm import lstm_int8_recurrence_plain, lstm_scan

    params, x, (xp, w_q, scale, b_hh) = _int8_case(cuda, 1024, 2, 24)
    with torch.no_grad():
        first, _ = lstm_scan(params, x, recurrent_dtype="int8")
        assert quantized(params["w_hh"])[0] is quantized(params["w_hh"])[0]
        want, _ = lstm_scan(params, x, recurrent_dtype="int8", int8_kernel=False)
        torch.testing.assert_close(first, want, atol=1e-2, rtol=0)
        params["w_hh"].mul_(-0.5)
        second, _ = lstm_scan(params, x, recurrent_dtype="int8")
        want, _ = lstm_scan(params, x, recurrent_dtype="int8", int8_kernel=False)
        torch.testing.assert_close(second, want, atol=1e-2, rtol=0)
        assert float((second - first).abs().max()) > 1e-2
        state = [torch.zeros(2, 1024, device=cuda)] * 2
        lstm_int8_recurrence(xp, w_q, scale, b_hh, *state)
        w_q.neg_()
        got, _ = lstm_int8_recurrence(xp, w_q, scale, b_hh, *state)
        want, _ = lstm_int8_recurrence_plain(xp, w_q, scale, b_hh, *state)
        torch.testing.assert_close(got, want, atol=1e-2, rtol=0)


def test_int8_lstm_scan_routes_to_k10(cuda):
    """lstm_scan(recurrent_dtype="int8") on a CUDA tensor: int8_kernel None
    takes K10 (from zero or a given state, any H), True keeps JAX's refusals
    and then takes K10, False runs the plain loop; a call K10 cannot take
    raises (B = 80 codes of h per CTA beyond shared memory, at H = 4096)."""
    from aec_tpu_torch.kernels.lstm_int8 import lstm_int8_recurrence
    from aec_tpu_torch.ops.lstm import lstm_scan

    params, x, _ = _int8_case(cuda, 256, 2, 16)
    h0 = torch.zeros(2, 256, device=cuda)
    for kw, want in ((dict(), 1), (dict(h0=h0, c0=h0), 1), (dict(int8_kernel=True), 1),
                     (dict(int8_kernel=False), 0)):
        before = lstm_int8_recurrence.launches
        lstm_scan(params, x, recurrent_dtype="int8", **kw)
        assert lstm_int8_recurrence.launches - before == want, kw
    p100, x100, _ = _int8_case(cuda, 100, 1, 8)
    before = lstm_int8_recurrence.launches
    lstm_scan(p100, x100, recurrent_dtype="int8")
    assert lstm_int8_recurrence.launches == before + 1
    with pytest.raises(ValueError, match="128-aligned"):
        lstm_scan(p100, x100, recurrent_dtype="int8", int8_kernel=True)
    big, xb, _ = _int8_case(cuda, 4096, 80, 2)
    before = lstm_int8_recurrence.launches
    with pytest.raises(ValueError, match="shared memory"):
        lstm_scan(big, xb, recurrent_dtype="int8")
    with pytest.raises(TypeError):
        lstm_scan({k: v.double() for k, v in params.items()}, x.double(), recurrent_dtype="int8")
    assert lstm_int8_recurrence.launches == before


def test_fullsubnet_and_att_ccrn_enhancers_run_their_kernels(cuda, scene, tmp_path):
    """cli/infer's FullSubNet and ATT-CCRN enhancers at full width on the
    card, one utterance each: K1 once (Kalman stage 1) and K11, resp. K10
    (``--lstm_dtype auto`` is int8 on the card), once; each wav within 1e-3
    of scale of the same path's plain route on the card (K1's round-off
    enters the nets' inputs; cuDNN's TF32 pinned off)."""
    from aec_tpu_torch.cli.infer import _make_enhancer, _tree_to
    from aec_tpu_torch.dsp.stft import StftConfig
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.kernels.lstm_int8 import lstm_int8_recurrence
    from aec_tpu_torch.models.att_ccrn import att_ccrn_apply, att_ccrn_init
    from aec_tpu_torch.models.fullsubnet import fullsubnet_apply, fullsubnet_init
    from aec_tpu_torch.train import checkpoints

    torch.backends.cudnn.allow_tf32 = False
    far, mic = (t.to(cuda) for t in scene(1, 100 * 256))
    lin = kalman_cancel_plain(KalmanConfig(), far, mic)["wav"]
    g = torch.Generator().manual_seed(0)
    fsn = fullsubnet_init(generator=g, device="cpu")
    att = att_ccrn_init(generator=g, device="cpu")
    cases = (
        ("fullsubnet", {"params": fsn}, joint_recurrence,
         lambda p: fullsubnet_apply(p, lin, far, joint_kernel=False)["wav"]),
        ("att_ccrn", {"params": att[0], "model_state": att[1]}, lstm_int8_recurrence,
         lambda p: att_ccrn_apply(p, _tree_to(att[1], cuda), lin, far,
                                  lstm_recurrent_dtype="int8", lstm_int8_kernel=False)[0]["wav"]),
    )
    for model, tree, kernel, plain in cases:
        path = str(tmp_path / f"{model}.npz")
        checkpoints.save(path, tree)
        enhance, params = _make_enhancer(model, path, "kalman", StftConfig(), device=cuda)
        before = kalman_cancel_fused_batched.launches, kernel.launches
        got = enhance(far, mic)
        torch.cuda.synchronize()
        assert (kalman_cancel_fused_batched.launches - before[0],
                kernel.launches - before[1]) == (1, 1), model
        with torch.no_grad():
            want = plain(params)
        assert got.shape == want.shape and bool(torch.isfinite(got).all()), model
        torch.testing.assert_close(got, want, atol=1e-3 * float(want.abs().max()), rtol=0)


@pytest.mark.parametrize("family", ["dccrn", "fullsubnet"])
def test_zoo_train_step_runs_its_kernel(cuda, scene, family):
    """One make_stateful_train_step step at B = 16 of a narrow DCCRN (K9 in
    both complex LSTM layers, 65 frames) and FullSubNet (K11), cuDNN's TF32
    off and deterministic (its default backward sums with atomics, so one
    route run twice would differ): the kernel route launches K9 twice /
    K11 once, the plain route (``lstm_fused=False`` / ``joint_kernel=False``)
    neither, and the kernel route's loss (rtol 1e-4), gradients and new
    BatchNorm state match the plain route's. Each gradient leaf within 1e-4
    of its scale (K8's gradient bar; the kernel route's backward on K9b),
    but the conv biases before a BatchNorm, whose exact gradient is
    zero (``bias_keys_before_batch_norm``), within 1e-3 of the largest
    leaf's scale in both routes; each statistic within 1e-5 of its
    BatchNorm's scale."""
    import copy

    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.kernels.fullsubnet import joint_recurrence
    from aec_tpu_torch.kernels.lstm import grouped_lstm_recurrence
    from aec_tpu_torch.models import dccrn, fullsubnet
    from aec_tpu_torch.models.tree_net import bias_keys_before_batch_norm, model_state
    from aec_tpu_torch.train.checkpoints import tree_map_with_path
    from aec_tpu_torch.train.loop import make_optimizer, make_stateful_train_step
    from aec_tpu_torch.utils.weights import param_tree

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(0)
    if family == "dccrn":
        cfg = dccrn.DccrnConfig(conv_channels=(4, 8, 16))
        net = dccrn.Dccrn(*dccrn.dccrn_init(cfg, generator=g, device="cpu"), cfg).to(cuda)
        kernel, launches, route = grouped_lstm_recurrence, 2, "lstm_fused"

        def loss(p, s, mic, far, near, echo, **kw):
            value, aux = dccrn.dccrn_loss_v1(p, s, mic, far, near, echo, cfg, **kw)
            return value, {"state": aux["state"]}
    else:
        cfg = fullsubnet.FullSubNetConfig(fb_hidden=32, sb_hidden=16)
        net = fullsubnet.FullSubNet(fullsubnet.fullsubnet_init(cfg, generator=g, device="cpu"),
                                    cfg).to(cuda)
        kernel, launches, route = joint_recurrence, 1, "joint_kernel"

        def loss(p, s, mic, far, near, echo, **kw):
            return fullsubnet.fullsubnet_loss(p, mic, far, near, echo, cfg, **kw)[0], {"state": s}

    far, mic = (t.to(cuda) for t in scene(16, 64 * 256))
    near = 0.1 * torch.roll(far, 1000, dims=1)
    batch = (mic + near, far, near, mic)
    out = {}
    for kw in ({}, {route: False}):
        mine = copy.deepcopy(net)
        step = make_stateful_train_step(lambda p, s, *b: loss(p, s, *b, **kw),
                                        make_optimizer(TrainConfig(), 1, mine))
        before = kernel.launches
        new_state, value = step(model_state(mine), *batch)
        torch.cuda.synchronize()
        out[bool(kw)] = (kernel.launches - before, float(value), new_state,
                         param_tree(mine, lambda p: p.grad))
    torch.backends.cudnn.deterministic = False
    (n_k, l_k, s_k, g_k), (n_p, l_p, s_p, g_p) = out[False], out[True]
    assert (n_k, n_p) == (launches, 0)
    assert abs(l_k / l_p - 1.0) <= 1e-4, (l_k, l_p)

    def flat(tree):
        out = {}
        tree_map_with_path(tree, out.__setitem__)
        return out

    zeros = bias_keys_before_batch_norm(param_tree(net))
    g_k, g_p = flat(g_k), flat(g_p)
    top = max(float(w.abs().max()) for w in g_p.values())
    for k, w in g_p.items():
        if k in zeros:
            assert max(float(w.abs().max()), float(g_k[k].abs().max())) <= 1e-3 * top, k
        else:
            torch.testing.assert_close(g_k[k], w, atol=1e-4 * float(w.abs().max()), rtol=0,
                                       msg=k)
    s_k, s_p = flat(s_k), flat(s_p)
    for k, w in s_p.items():
        bn = k.rsplit("[", 1)[0]
        scale = max(float(v.abs().max()) for j, v in s_p.items() if j.rsplit("[", 1)[0] == bn)
        torch.testing.assert_close(s_k[k], w, atol=1e-5 * scale, rtol=0, msg=k)


@pytest.fixture
def h5_files(monkeypatch):
    """The .ex files through h5py, or, on a machine without it, through the
    npz-backed stand-in chip_smoke.py uses there (tests/test_torch_data.py
    holds it to h5io's round trip)."""
    import importlib.util
    import sys

    if importlib.util.find_spec("h5py") is None:
        import chip_smoke

        monkeypatch.setitem(sys.modules, "h5py", chip_smoke.npz_h5py())


def _write_corpus(tmp_path, scene, n_utts, n_cv, n):
    from aec_tpu_torch.pipeline import h5io

    far, mic = scene(n_utts + n_cv, n)
    utts = [{"nearend_speech": (m - 0.9 * f).numpy(), "nearend_mic": m.numpy(),
             "farend_speech": f.numpy(), "echo": (0.9 * f).numpy()} for f, m in zip(far, mic)]
    files = [str(tmp_path / f"tr_{i}.ex") for i in range(n_utts)]
    for p, u in zip(files, utts):
        h5io.write_utterance(p, u)
    cv = str(tmp_path / "cv.ex")
    h5io.write_grouped(cv, utts[n_utts:])
    return files, cv


def test_cached_trainer_equals_host_loader(cuda, scene, tmp_path, h5_files):
    """One epoch of 3 steps at batch 4 from a float32 device cache and from
    the host loader on the card, the same initial net: per-step losses
    within 1e-6 relative, every parameter within 1e-6 of its leaf's scale;
    each of the 3 steps (batch 4 x 81 frames) launches K8 and K8b once, and
    cached validation of 3 utterances of 81 frames K8 once each."""
    from aec_tpu_torch.configs import TrainConfig
    from aec_tpu_torch.train.loop import Trainer
    from aec_tpu_torch.utils.weights import params_to_jax

    files, cv = _write_corpus(tmp_path, scene, 12, 3, 80 * 256)
    runs = {}
    for tag, cache in (("host", ""), ("cached", "float32")):
        losses = []

        def loss_fn(net, *args, **kw):
            loss, aux = little_net_loss(net, *args, **kw)
            if torch.is_grad_enabled():
                losses.append(loss.detach())
            return loss, aux

        before = gru_recurrence.launches, gru_backward.launches
        out = Trainer(files, cv, str(tmp_path / tag), cfg=TrainConfig(batch_size=4, lr=1e-3,
                      max_n_epochs=1), loss_fn=loss_fn, device_cache=cache, device=cuda).train()
        runs[tag] = ([float(v) for v in losses], params_to_jax(out["net"]),
                     (gru_recurrence.launches - before[0], gru_backward.launches - before[1]))
    (l_h, p_h, _), (l_c, p_c, k8) = runs["host"], runs["cached"]
    assert len(l_h) == len(l_c) == 3 and k8 == (3 + 3, 3)
    for a, b in zip(l_c, l_h):
        assert abs(a / b - 1.0) <= 1e-6, (l_c, l_h)
    for x in p_h:
        for y in p_h[x]:
            scale = float(np.abs(p_h[x][y]).max())
            assert float(np.abs(p_c[x][y] - p_h[x][y]).max()) <= 1e-6 * scale, (x, y)


@pytest.mark.parametrize("stage1", ["kalman", "nlms"])
def test_batch_enhance_launches_its_stage1_kernel(cuda, scene, tmp_path, h5_files, stage1,
                                                  capsys):
    """cli/batch_enhance on 3 utterances at --batch 2: K1 (Kalman) or K5
    (NLMS) once a batch, K8 once a batch (79 frames); every wav
    within K1's / K5's bar (1e-3 of max|mic|) of the same CLI on the CPU."""
    from aec_tpu_torch.cli import batch_enhance
    from aec_tpu_torch.pipeline import h5io
    from aec_tpu_torch.pipeline.audio_io import read_wav

    _, cv = _write_corpus(tmp_path, scene, 0, 3, 20000)
    lst = str(tmp_path / "tt_list.txt")
    h5io.write_filelist(lst, [cv])
    kernel = kalman_cancel_fused_batched if stage1 == "kalman" else nlms_cancel_fused_batched
    before = kernel.launches, gru_recurrence.launches
    for dev in ("cuda", "cpu"):
        batch_enhance.main(["--tt_list", lst, "--model_file", ROBUST, "--out_dir",
                            str(tmp_path / dev), "--batch", "2", "--stage1", stage1,
                            "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (kernel.launches - before[0], gru_recurrence.launches - before[1]) == (2, 2)
    assert '"xrt"' in capsys.readouterr().out
    mic_scale = max(float(np.abs(h5io.read_group(cv, i)["nearend_mic"]).max()) for i in range(3))
    for k in range(3):
        got = read_wav(str(tmp_path / "cuda" / f"{k}_enhanced.wav"))[0]
        want = read_wav(str(tmp_path / "cpu" / f"{k}_enhanced.wav"))[0]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert float(np.abs(got - want).max()) <= 1e-3 * mic_scale, k


def _synthetic_step(dev, width=1, b=4, n=64 * 256):
    """A train_synthetic step's pieces on ``dev``: its scenes (drawn and
    made on the card), a fresh net of ``width`` and its step (the default
    recipe, the script's optimizer)."""
    from aec_tpu_torch.examples import train_synthetic as ts
    from aec_tpu_torch.train.loop import make_train_step

    gen = torch.Generator(device=dev).manual_seed(0)
    far, mic, near = ts.synthesize_scenes(ts.scene_draws(gen, b, n), n)
    net = little_net_init(width=width, generator=torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(ts.recipe_loss(), ts.recipe_optimizer(net, 3e-3, 100))
    return (far, mic, near), net, step


@pytest.mark.parametrize("width", [1, 4])
def test_train_synthetic_step_launches_k1_k8_k8b_once(cuda, width):
    """One train_synthetic step on the card (4 scenes x 65 frames): stage 1
    on K1, the loss's GRU on K8 forward and K8b backward, once each; the
    loss and the updated net within the train-step bars (loss rtol 1e-4,
    each leaf's mean |d| <= 1e-3 lr) of the CPU route fed the same linear
    output."""
    from aec_tpu_torch.examples import train_synthetic as ts

    (far, mic, near), net, step = _synthetic_step(cuda, width)
    _, cpu_net, cpu_step = _synthetic_step("cpu", width)
    erb = torch.as_tensor(erb_filterbank(), device=cuda)
    before = (kalman_cancel_fused_batched.launches, gru_recurrence.launches,
              gru_backward.launches)
    lin = ts.linear_output(KalmanConfig(), far, mic)
    loss = float(step(lin, far, near, erb))
    torch.cuda.synchronize()
    after = (kalman_cancel_fused_batched.launches, gru_recurrence.launches, gru_backward.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    cpu_loss = float(cpu_step(lin.cpu(), far.cpu(), near.cpu(), erb.cpu()))
    assert np.isfinite(loss) and abs(loss / cpu_loss - 1.0) <= 1e-4, (loss, cpu_loss)
    for p, q in zip(net.parameters(), cpu_net.parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().mean()) <= 1e-3 * 3e-3


@pytest.mark.parametrize("missing", ["K1", "K8", "K8b"])
def test_train_synthetic_step_raises_without_its_kernels(cuda, monkeypatch, missing):
    """A train_synthetic step on the card whose kernel cannot be had (its
    library fails to build: K1, K8; K8b's launch fails) raises; it never
    falls back to a plain version."""
    from aec_tpu_torch.examples import train_synthetic as ts
    from aec_tpu_torch.kernels import gru as kgru
    from aec_tpu_torch.kernels import kalman as kkalman

    def unavailable(*args, **kwargs):
        raise RuntimeError(f"{missing} is unavailable")

    (far, mic, near), _, step = _synthetic_step(cuda)
    erb = torch.as_tensor(erb_filterbank(), device=cuda)
    target = {"K1": (kkalman, "_lib"), "K8": (kgru, "_lib"), "K8b": (kgru, "gru_backward")}
    monkeypatch.setattr(*target[missing], unavailable)
    with pytest.raises(RuntimeError, match=f"{missing} is unavailable"):
        step(ts.linear_output(KalmanConfig(), far, mic), far, near, erb)
        torch.cuda.synchronize()


def test_serving_loop_first_block_on_k3(cuda):
    """serving_loop on the card: every block one K3 launch, the first
    included; the outputs within K3's bar (1e-3 of each block's scale) of
    serving_step_plain on the same blocks."""
    from aec_tpu_torch.examples import serving_loop as sl
    from aec_tpu_torch.kernels.serving import serving_step_fused, serving_step_plain

    net = sl.load_net(cuda)
    far, mic = sl.make_sessions(8, 3)
    before = serving_step_fused.launches
    got, lat, _ = sl.serve(net, far, mic, cuda)
    assert serving_step_fused.launches - before == 3 and len(lat) == 3
    want, _, _ = sl.serve(net, far, mic, cuda, step=serving_step_plain)
    for t in range(2):
        blk = slice(t * sl.HOP, (t + 1) * sl.HOP)
        scale = max(float(np.abs(want[:, blk]).max()), 1e-9)
        assert float(np.abs(got[:, blk] - want[:, blk]).max()) <= 1e-3 * scale, t
