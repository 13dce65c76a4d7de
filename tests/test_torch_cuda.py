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
from aec_tpu_torch.kernels.gru import gru_recurrence, gru_scan_fused, gru_scan_fused_plain
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
from aec_tpu_torch.ops.gru import gru_init, gru_scan
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
    net = load_npz(ROBUST, device="cpu")
    want = two_stage_cancel(net, far, mic, erb_filterbank())
    k1, k2 = kalman_cancel_fused_batched.launches, little_net_apply_fused.launches
    got = two_stage_cancel(net.to(cuda), far.to(cuda), mic.to(cuda), erb_filterbank())
    assert kalman_cancel_fused_batched.launches == k1 + 1
    assert little_net_apply_fused.launches == k2 + 1
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
    other inputs (a race between the cluster's exchanges would show as a
    small, input-dependent error); K6 also against K1 as a batch of one."""
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
        with pytest.raises(ValueError, match="shared memory"):
            fn(cfg(n_blocks=30), f, m)
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
    if b == 1:  # gru_scan's own route at B == 1, T >= 64 takes K8 at any width
        with torch.no_grad():
            routed, _ = gru_scan(params, x, h0)
        assert gru_recurrence.launches == before + 2
        torch.testing.assert_close(routed, ys, atol=0, rtol=0)


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
    """A batch-1 T >= 64 scan on the card routes to K8; its gradients (the
    plain scan recomputed) equal the plain route's to 1e-5 of scale."""
    params, x, h0 = _gru_case(cuda, 1, 200, 32)
    leaves = [x, h0, *params.values()]
    for t in leaves:
        t.requires_grad_()
    before = gru_recurrence.launches
    ys, h_t = gru_scan(params, x, h0)
    assert gru_recurrence.launches == before + 1
    got = torch.autograd.grad((ys * ys).sum() + h_t.sum(), leaves)
    ys2, h2 = gru_scan(params, x, h0, fused=False)
    want = torch.autograd.grad((ys2 * ys2).sum() + h2.sum(), leaves)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-5 * float(w.abs().max()), rtol=0)


def test_batch_one_loss_backward_launches_gru_kernel(cuda, scene):
    """A batch-1 little_net_loss on the card (and its backward) goes through
    K8; the gradients match the same loss on the CPU route."""
    net = little_net_init(generator=torch.Generator().manual_seed(1))
    cpu_net = little_net_init(generator=torch.Generator().manual_seed(1), device="cpu")
    mic, far = scene(1, 80 * 256)
    near = 0.3 * mic
    erb = torch.from_numpy(erb_filterbank())
    before = gru_recurrence.launches
    loss, _ = little_net_loss(net, mic.to(cuda), far.to(cuda), near.to(cuda), erb.to(cuda),
                              sqrt_eps=1e-12)
    loss.backward()
    assert gru_recurrence.launches == before + 1
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
    assert n_max >= (18 if hop == 256 else 38)
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


@pytest.mark.parametrize("b", [1, 8])
def test_lstm_kernel_matches_plain(cuda, b):
    """K9 at DCCRN's full width (I = H = 1024 per part) over T = 513 frames
    vs its plain version: h in [-1, 1], fp32 in another summation order ->
    1e-5 absolute."""
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
    """The Function's backward recomputes the plain grouped scan from the
    same inputs and cotangents, so its gradients equal the plain route's to
    1e-5 of each leaf's scale."""
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
                                       (40, 24, 3, 30)])
def test_fullsubnet_kernel_matches_plain(cuda, fb, sb, b, t):
    """K11 against its plain joint loop at narrow and FullSubNetConfig()
    widths, B = 1 and 4: h in [-1, 1], an fp32 recursion summed in another
    order -> 1e-5 absolute."""
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
    none); the Function's gradients (recomputed through the plain loop)
    equal the plain route's to 1e-5 of each leaf's scale."""
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


def _int8_case(cuda, h, b, t, seed=0):
    from aec_tpu_torch.ops.lstm import lstm_init, quantize_rows_int8

    g = torch.Generator().manual_seed(seed)
    params = lstm_init(h, h, generator=g, device=cuda)
    x = torch.randn(b, t, h, generator=g).to(cuda)
    xp = x @ params["w_ih"].T + params["b_ih"]
    w_q, scale = quantize_rows_int8(params["w_hh"])
    return params, x, (xp, w_q, scale / 127.0, params["b_hh"])


@pytest.mark.parametrize("h,b,t", [(128, 1, 40), (1024, 1, 64), (4096, 1, 64), (1024, 3, 32),
                                   (100, 2, 20), (4096, 9, 8)])
def test_int8_kernel_matches_plain(cuda, h, b, t):
    """K10 against the plain int8 loop, ATT-CCRN's H = 4096 included, B > 1
    and an H that is no multiple of 16, from zero and from a given state.
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
