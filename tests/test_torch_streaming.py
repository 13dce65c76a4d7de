"""Port streaming runtime (aec_tpu_torch.pipeline.streaming) == JAX."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.dsp.erb import erb_filterbank
from aec_tpu.models.little_net import little_net_init
from aec_tpu.pipeline import streaming as jst
from aec_tpu.train import checkpoints
from aec_tpu_torch.pipeline import streaming as tst
from aec_tpu_torch.pipeline.two_stage import two_stage_cancel
from aec_tpu_torch.utils.weights import load_npz

ROBUST = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "little_net_robust.npz")
HOP = 256


def _jax_robust():
    return checkpoints.restore(ROBUST, {"params": little_net_init(jax.random.PRNGKey(0))})["params"]


def _sessions(rng, s, hops):
    """S echo sessions: far noise through a decaying RIR plus near-end noise."""
    n = hops * HOP
    far = rng.standard_normal((s, n)).astype(np.float32)
    rir = (0.3 * np.exp(-np.arange(200) / 50.0) * rng.standard_normal(200)).astype(np.float32)
    mic = np.stack([np.convolve(f, rir)[:n] for f in far]) + 0.05 * rng.standard_normal((s, n))
    return far, mic.astype(np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _assert_states_close(got, want, rel):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for key in w:
        assert g[key].shape == w[key].shape, key
        scale = max(float(np.abs(w[key]).max()), 1e-9)
        np.testing.assert_allclose(g[key], w[key], atol=rel * scale, rtol=0, err_msg=key)


@pytest.mark.parametrize(
    "stage1,normalize,gain_norm",
    [("kalman", False, False), ("kalman", True, False), ("kalman", False, True),
     ("none", True, True), ("nlms", False, False), ("nlms", True, True)],
)
def test_stream_step_batched_matches_jax(rng, stage1, normalize, gain_norm):
    """12 hops of 4 sessions: every emitted block and, at the end, every state
    leaf. The JAX scan step at fp32 on the CPU; bars as the JAX suite's
    kernel-vs-scan serving test (2e-4 output, 3e-4 state, of scale)."""
    s, hops = 4, 12
    far, mic = _sessions(rng, s, hops)
    erb = erb_filterbank()
    params, net = _jax_robust(), load_npz(ROBUST)
    js = jst.stream_init_batched(s, stage1=stage1)
    ts = tst.stream_init_batched(s, stage1=stage1)
    _assert_states_close(ts, js, 0.0)
    kw = dict(stage1=stage1, normalize=normalize, gain_norm=gain_norm)
    for t in range(hops):
        fb, mb = far[:, t * HOP : (t + 1) * HOP], mic[:, t * HOP : (t + 1) * HOP]
        js, out_j = jst.stream_step_batched(params, js, jnp.asarray(fb), jnp.asarray(mb),
                                            jnp.asarray(erb), **kw)
        ts, out_t = tst.stream_step_batched(net, ts, torch.from_numpy(fb),
                                            torch.from_numpy(mb), erb, **kw)
        out_j = np.asarray(out_j)
        assert out_t.shape == out_j.shape == (s, HOP)
        scale = max(float(np.abs(out_j).max()), 1e-9)
        np.testing.assert_allclose(out_t.numpy(), out_j, atol=2e-4 * scale, rtol=0)
    _assert_states_close(ts, js, 3e-4)
    assert ts["gru_h"].shape == (s, 1, 32)


@pytest.mark.parametrize("normalize", [False, True])
def test_stream_run_and_flush_match_jax(rng, normalize):
    far, mic = _sessions(rng, 1, 10)
    erb = erb_filterbank()
    want = jst.stream_run(_jax_robust(), far[0], mic[0], jnp.asarray(erb), normalize=normalize)
    got = tst.stream_run(load_npz(ROBUST), far[0], mic[0], erb, normalize=normalize)
    assert got.shape == want.shape == (10 * HOP,)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * scale, rtol=0)


def test_batched_flush_matches_per_stream_flush(rng):
    s, hops = 3, 6
    far, mic = _sessions(rng, s, hops)
    erb = erb_filterbank()
    net = load_npz(ROBUST)
    st = tst.stream_init_batched(s)
    for t in range(hops):
        st, _ = tst.stream_step_batched(net, st, torch.from_numpy(far[:, t * HOP : (t + 1) * HOP]),
                                        torch.from_numpy(mic[:, t * HOP : (t + 1) * HOP]), erb,
                                        normalize=True)
    batched = tst.stream_flush(net, st, erb, normalize=True)
    assert batched.shape == (s, HOP)
    for i in range(s):
        one = tst.stream_flush(net, tst._tree_map(lambda a: a[i], st), erb, normalize=True)
        torch.testing.assert_close(one, batched[i], atol=1e-5 * float(batched.abs().max()),
                                   rtol=0)


def test_streaming_equals_offline(rng):
    """Port stream_run == port offline two_stage_cancel (normalize=False),
    within the JAX streaming bound of 2e-3 of signal scale."""
    far, mic = _sessions(rng, 2, 16)
    erb = erb_filterbank()
    net = load_npz(ROBUST)
    offline = two_stage_cancel(net, torch.from_numpy(far), torch.from_numpy(mic), erb)["wav"]
    for i in range(2):
        streamed = tst.stream_run(net, far[i], mic[i], erb)
        scale = float(offline[i].abs().max())
        torch.testing.assert_close(streamed, offline[i], atol=2e-3 * scale, rtol=0)


def test_stream_step_is_a_batch_of_one(rng):
    far, mic = _sessions(rng, 2, 3)
    erb = erb_filterbank()
    net = load_npz(ROBUST)
    sb, so = tst.stream_init_batched(2), tst.stream_init()
    for t in range(3):
        fb, mb = torch.from_numpy(far[:, t * HOP : (t + 1) * HOP]), torch.from_numpy(
            mic[:, t * HOP : (t + 1) * HOP])
        sb, ob = tst.stream_step_batched(net, sb, fb, mb, erb)
        so, oo = tst.stream_step(net, so, fb[1], mb[1], erb, quality="fast")
        assert oo.shape == (HOP,)
        torch.testing.assert_close(oo, ob[1], atol=1e-5 * float(ob.abs().max()), rtol=0)


def test_nlms_and_unknown_options_raise(rng):
    """stage1="nlms" streams as JAX's stream_run does (2e-4 of scale), with
    the NLMS state leaves; unknown options raise."""
    from aec_tpu.configs import NlmsConfig as JaxNlmsConfig
    from aec_tpu_torch.configs import NlmsConfig

    st = tst.stream_init(stage1="nlms")
    assert sorted(st["stage1"]) == ["power", "psi", "w", "x_buf"]
    assert not any(bool(v.any()) for v in st["stage1"].values())
    far, mic = _sessions(rng, 1, 10)
    cfg = {"mu": 0.4, "eps_rel": 0.05}
    want = jst.stream_run(_jax_robust(), far[0], mic[0], jnp.asarray(erb_filterbank()),
                          stage1="nlms", lin_cfg=JaxNlmsConfig(**cfg))
    got = tst.stream_run(load_npz(ROBUST), far[0], mic[0], erb_filterbank(), stage1="nlms",
                         lin_cfg=NlmsConfig(**cfg))
    assert got.shape == want.shape == (10 * HOP,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * float(np.abs(want).max()), rtol=0)
    with pytest.raises(ValueError, match="stage1"):
        tst.stream_init(stage1="rls")
    with pytest.raises(ValueError, match="quality"):
        tst.stream_step_batched(load_npz(ROBUST), tst.stream_init_batched(1),
                                torch.zeros(1, HOP), torch.zeros(1, HOP), erb_filterbank(),
                                quality="bf16")
