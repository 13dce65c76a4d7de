"""Port serving runtime (aec_tpu_torch.kernels.serving) == JAX pallas_serving."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.dsp.erb import erb_filterbank
from aec_tpu.kernels import pallas_serving as jsv
from aec_tpu.models.little_net import little_net_init
from aec_tpu_torch.kernels import serving as tsv
from aec_tpu_torch.pipeline import streaming as tst
from aec_tpu_torch.utils.weights import load_npz, params_from_jax

ROBUST = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "little_net_robust.npz")
HOP, S = 256, 4


def _nets():
    """The JAX suite's random-init net (tests/test_pallas_serving.py) in both
    packages. With it the JAX kernel's bf16_3x products sit within 6e-5 of
    scale of fp32; the sharper robust checkpoint takes them to ~4e-4."""
    params = little_net_init(jax.random.PRNGKey(0))
    return params, params_from_jax(params)


def _sessions(rng, hops, s=S):
    n = hops * HOP
    far = rng.standard_normal((s, n)).astype(np.float32)
    rir = (0.3 * np.exp(-np.arange(200) / 50.0) * rng.standard_normal(200)).astype(np.float32)
    mic = np.stack([np.convolve(f, rir)[:n] for f in far]) + 0.05 * rng.standard_normal((s, n))
    return far, mic.astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _run(rng, hops, chunk, stage1="kalman", **kw):
    """The port's plain step and JAX's interpret-mode kernel over the same
    sessions (drawn as tests/test_pallas_serving.py draws them: echo only),
    ``chunk`` blocks per call; returns both final states and the emitted
    blocks of both."""
    rir = (np.exp(-np.arange(200) / 50.0) * rng.standard_normal(200)).astype(np.float32) * 0.3
    far = rng.standard_normal((S, hops * HOP)).astype(np.float32)
    mic = np.stack([np.convolve(f, rir)[: hops * HOP] for f in far]).astype(np.float32)
    erb = erb_filterbank()
    params, net = _nets()
    js = jsv.serving_init(S, tile=S, stage1=stage1)
    ts = tsv.serving_init(S, stage1=stage1)
    kw["stage1"] = stage1
    outs_j, outs_t = [], []
    for lo in range(0, hops * HOP, chunk * HOP):
        fb, mb = far[:, lo : lo + chunk * HOP], mic[:, lo : lo + chunk * HOP]
        js, oj = jsv.serving_step_fused(params, js, jnp.asarray(fb), jnp.asarray(mb),
                                        jnp.asarray(erb), interpret=True, dot_mode="high", **kw)
        ts, ot = tsv.serving_step_fused(net, ts, torch.from_numpy(fb), torch.from_numpy(mb), erb,
                                        **kw)
        outs_j.append(np.asarray(oj))
        outs_t.append(ot.numpy())
    return js, ts, np.concatenate(outs_j, -1), np.concatenate(outs_t, -1)


def _check_against_jax(rng, stage1, normalize, gain_norm, state_bar=3e-4):
    js, ts, out_j, out_t = _run(rng, 12, 1, stage1, normalize=normalize, gain_norm=gain_norm)
    assert out_t.shape == out_j.shape == (S, 12 * HOP)
    for t in range(12):
        blk = slice(t * HOP, (t + 1) * HOP)
        scale = max(float(np.abs(out_j[:, blk]).max()), 1e-9)
        np.testing.assert_allclose(out_t[:, blk], out_j[:, blk], atol=2e-4 * scale, rtol=0)
    want = _flat(jsv.serving_state_to_stream(js, stage1=stage1))
    got = _flat(tsv.serving_state_to_stream(ts, stage1=stage1))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        scale = max(float(np.abs(want[key]).max()), 1e-9)
        np.testing.assert_allclose(got[key], want[key], atol=state_bar * scale, rtol=0,
                                   err_msg=key)
    nm_j = np.transpose(np.asarray(js["nm"]), (0, 2, 1)).reshape(S, 8)
    np.testing.assert_allclose(ts["nm"][:, 5:].numpy(), nm_j[:, 5:], rtol=3e-4, atol=1e-12)
    np.testing.assert_allclose(tsv.serving_erle(ts).numpy(), np.asarray(jsv.serving_erle(js)),
                               atol=1e-3)
    return ts


@pytest.mark.parametrize("normalize,gain_norm", [(False, False), (True, False), (False, True)])
def test_serving_step_plain_matches_jax_kernel(rng, normalize, gain_norm):
    """12 one-block calls for 4 sessions: output blocks at 2e-4 of scale, every
    state leaf (through serving_state_to_stream on both sides) at 3e-4 of
    scale (the bars of tests/test_pallas_serving.py), the monitor rows and
    serving_erle."""
    _check_against_jax(rng, "kalman", normalize, gain_norm)


@pytest.mark.parametrize("normalize,gain_norm", [(False, False), (True, True)])
def test_nlms_serving_step_plain_matches_jax_kernel(rng, normalize, gain_norm):
    """The same with the NLMS stage 1: JAX's kernel at stage1="nlms", the
    (S, K) far power in the ``p`` leaf, ``power`` in the StreamState. The
    state leaves at 3e-3 of scale, the JAX suite's NLMS bar
    (tests/test_pallas_serving.py:93-97): NLMS cancels deeper, so the GRU's
    h feels the kernel's bf16_3x products more; the outputs stay at 2e-4."""
    ts = _check_against_jax(rng, "nlms", normalize, gain_norm, state_bar=3e-3)
    assert ts["p"].shape == (S, 257) and bool(ts["p"].any())


def test_nlms_migrations_are_exact_inverses(rng):
    """Both NLMS migrations round-trip bit for bit, ``p`` <-> ``power``, and
    a StreamState from JAX's own NLMS migration lands in the port's layout."""
    js, ts, _, _ = _run(rng, 5, 1, "nlms", normalize=True)
    st = tsv.serving_state_to_stream(ts, stage1="nlms")
    assert "power" in st["stage1"] and "p" not in st["stage1"]
    back = tsv.serving_state_from_stream(st, stage1="nlms")
    for key in ts:
        if key == "nm":  # the monitor rows are the kernel's own, and start at 0
            assert torch.equal(back[key][:, :5], ts[key][:, :5])
        else:
            assert torch.equal(back[key], ts[key]), key
    again = _flat(tsv.serving_state_to_stream(back, stage1="nlms"))
    for key, want in _flat(st).items():
        np.testing.assert_array_equal(again[key], want, err_msg=key)
    jst_ = _tree_to_torch(jsv.serving_state_to_stream(js, stage1="nlms"))
    from_jax = tsv.serving_state_from_stream(jst_, stage1="nlms")
    assert all(from_jax[k].shape == ts[k].shape for k in ts)
    for key, want in _flat(jst_).items():
        np.testing.assert_array_equal(
            _flat(tsv.serving_state_to_stream(from_jax, stage1="nlms"))[key], want, err_msg=key)


def test_nlms_serving_matches_streaming_and_resets(rng):
    """NLMS serving == stream_step_batched(stage1="nlms") bit for bit (both
    plain); the flush; a reset slot equals a fresh NLMS slot (all zeros)."""
    from aec_tpu_torch.configs import NlmsConfig

    far, mic = _sessions(rng, 4)
    net, erb, cfg = load_npz(ROBUST), erb_filterbank(), NlmsConfig(mu=0.3)
    ks = tsv.serving_init(S, kcfg=cfg, stage1="nlms")
    ss = tst.stream_init_batched(S, stage1="nlms", lin_cfg=cfg)
    for t in range(4):
        fb = torch.from_numpy(far[:, t * HOP : (t + 1) * HOP])
        mb = torch.from_numpy(mic[:, t * HOP : (t + 1) * HOP])
        ks, ok = tsv.serving_step_fused(net, ks, fb, mb, erb, cfg, stage1="nlms")
        ss, os_ = tst.stream_step_batched(net, ss, fb, mb, erb, stage1="nlms", lin_cfg=cfg)
        assert torch.equal(ok, os_)
    st = tsv.serving_state_to_stream(ks, stage1="nlms")
    for key, want in _flat(ss).items():
        np.testing.assert_array_equal(_flat(st)[key], want, err_msg=key)
    assert torch.equal(tst.stream_flush(net, st, erb), tst.stream_flush(net, ss, erb))
    done = torch.tensor([False, True, False, True])
    tsv.serving_reset_streams(ks, done, kcfg=cfg, stage1="nlms")
    init = tsv.serving_init(S, kcfg=cfg, stage1="nlms")
    for key in ks:
        assert torch.equal(ks[key][done], init[key][done]), key
        assert not init[key].any(), key


def test_chunked_call_equals_single_calls(rng):
    """One k = 3 call == three k = 1 calls (bit for bit in the port), and ==
    JAX's k = 3 chunked kernel call."""
    far, mic = _sessions(rng, 6)
    net, erb = load_npz(ROBUST), erb_filterbank()
    one, three = tsv.serving_init(S), tsv.serving_init(S)
    outs = []
    for t in range(6):
        one, o = tsv.serving_step_fused(net, one, torch.from_numpy(far[:, t * HOP : (t + 1) * HOP]),
                                        torch.from_numpy(mic[:, t * HOP : (t + 1) * HOP]), erb,
                                        normalize=True)
        outs.append(o)
    chunks = []
    for lo in (0, 3 * HOP):
        three, o = tsv.serving_step_fused(net, three, torch.from_numpy(far[:, lo : lo + 3 * HOP]),
                                          torch.from_numpy(mic[:, lo : lo + 3 * HOP]), erb,
                                          normalize=True)
        chunks.append(o)
    assert torch.equal(torch.cat(outs, -1), torch.cat(chunks, -1))
    for key in one:
        assert torch.equal(one[key], three[key]), key

    js, ts, out_j, out_t = _run(np.random.default_rng(7), 6, 3)
    scale = float(np.abs(out_j).max())
    np.testing.assert_allclose(out_t, out_j, atol=2e-4 * scale, rtol=0)
    want, got = _flat(jsv.serving_state_to_stream(js)), _flat(tsv.serving_state_to_stream(ts))
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-9)
        np.testing.assert_allclose(got[key], want[key], atol=3e-4 * scale, rtol=0, err_msg=key)


def test_serving_matches_streaming_and_flushes(rng):
    """The serving step == stream_step_batched (both plain, same numbers), and
    the end of a session: serving_state_to_stream + stream_flush."""
    far, mic = _sessions(rng, 5)
    net, erb = load_npz(ROBUST), erb_filterbank()
    ks, ss = tsv.serving_init(S), tst.stream_init_batched(S)
    for t in range(5):
        fb = torch.from_numpy(far[:, t * HOP : (t + 1) * HOP])
        mb = torch.from_numpy(mic[:, t * HOP : (t + 1) * HOP])
        ks, ok = tsv.serving_step_fused(net, ks, fb, mb, erb, normalize=True)
        ss, os_ = tst.stream_step_batched(net, ss, fb, mb, erb, normalize=True)
        assert torch.equal(ok, os_)
    got = _flat(tsv.serving_state_to_stream(ks))
    for key, want in _flat(ss).items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    last = tst.stream_flush(net, tsv.serving_state_to_stream(ks), erb, normalize=True)
    assert torch.equal(last, tst.stream_flush(net, ss, erb, normalize=True))


def test_migrations_are_exact_inverses(rng):
    js, ts, _, _ = _run(rng, 5, 1, normalize=True)
    back = tsv.serving_state_from_stream(tsv.serving_state_to_stream(ts))
    for key in ts:
        if key == "nm":  # the monitor rows are the kernel's own, and start at 0
            assert torch.equal(back[key][:, :5], ts[key][:, :5])
            assert not back[key][:, 5:].any()
        else:
            assert torch.equal(back[key], ts[key]), key
    st = tsv.serving_state_to_stream(ts)
    again = _flat(tsv.serving_state_to_stream(tsv.serving_state_from_stream(st)))
    for key, want in _flat(st).items():
        np.testing.assert_array_equal(again[key], want, err_msg=key)
    # the leaf names are JAX's, and a StreamState that JAX's own migration
    # gives round-trips through the port's layout exactly
    assert set(ts) == set(js)
    jst_ = _tree_to_torch(jsv.serving_state_to_stream(js))
    from_jax = tsv.serving_state_from_stream(jst_)
    assert all(from_jax[k].shape == ts[k].shape for k in ts)
    again = _flat(tsv.serving_state_to_stream(from_jax))
    for key, want in _flat(jst_).items():
        np.testing.assert_array_equal(again[key], want, err_msg=key)


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def test_reset_streams_and_init(rng):
    _, ts, _, _ = _run(rng, 4, 1)
    init = tsv.serving_init(S)
    assert set(init) == set(jsv.serving_init(S, tile=S))
    assert init["wr"].shape == (S, 10, 257) and init["nm"].shape == (S, 8)
    done = torch.tensor([True, False, True, False])
    before = {k: v.clone() for k, v in ts.items()}
    assert tsv.serving_reset_streams(ts, done) is ts
    for key in ts:
        assert torch.equal(ts[key][done], init[key][done]), key
        assert torch.equal(ts[key][~done], before[key][~done]), key
    assert torch.equal(tsv.serving_erle(ts)[done], torch.zeros(2))


def test_wrapper_takes_plain_version_on_cpu(rng):
    far, mic = _sessions(rng, 2)
    net, erb = load_npz(ROBUST), erb_filterbank()
    before = tsv.serving_step_fused.launches
    a, oa = tsv.serving_step_fused(net, tsv.serving_init(S), torch.from_numpy(far),
                                   torch.from_numpy(mic), erb)
    b, ob = tsv.serving_step_plain(net, tsv.serving_init(S), torch.from_numpy(far),
                                   torch.from_numpy(mic), erb)
    assert torch.equal(oa, ob) and all(torch.equal(a[k], b[k]) for k in a)
    assert tsv.serving_step_fused.launches == before


def test_serving_refuses_what_it_cannot_take(rng):
    net, erb = load_npz(ROBUST), erb_filterbank()
    nlms = tsv.serving_init(S, stage1="nlms")  # the (S, K) far power in `p`
    assert nlms["p"].shape == nlms["psi"].shape == (S, 257) and nlms["wr"].shape == (S, 10, 257)
    _, out = tsv.serving_step_fused(net, nlms, torch.zeros(S, HOP), torch.zeros(S, HOP), erb,
                                    stage1="nlms")
    assert out.shape == (S, HOP) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="k \\* 256"):
        tsv.serving_step_fused(net, tsv.serving_init(S), torch.zeros(S, HOP + 1),
                               torch.zeros(S, HOP + 1), erb)
    with pytest.raises(ValueError, match="stage1"):
        tsv.serving_init(S, stage1="none")
