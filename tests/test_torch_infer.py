"""Port inference slice == JAX: dsp/delay, pipeline/audio_io, models/two_layer_gru
and ``cli/infer`` (little_net, two_layer_gru, dccrn, fullsubnet, att_ccrn) on
a tiny ``.ex`` file, against the JAX CLI's wavs."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.cli import infer as jax_infer
from aec_tpu.dsp import delay as jdelay
from aec_tpu.dsp.erb import erb_filterbank
from aec_tpu.models import att_ccrn as jatt
from aec_tpu.models import fullsubnet as jfsn
from aec_tpu.models import two_layer_gru as jtl
from aec_tpu.pipeline import audio_io as jio
from aec_tpu.train import checkpoints as jck
from aec_tpu_torch.cli import infer
from aec_tpu_torch.dsp import delay
from aec_tpu_torch.models import dccrn as td
from aec_tpu_torch.models import two_layer_gru as ttl
from aec_tpu_torch.pipeline import audio_io
from aec_tpu_torch.pipeline import h5io
from aec_tpu_torch.train import checkpoints
from aec_tpu_torch.utils.weights import two_layer_gru_from_jax, two_layer_gru_to_jax

REPO = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(REPO, "checkpoints", "little_net_general.npz")


def _delayed(rng, b, n, delays):
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (np.exp(-np.arange(200) / 40.0) * rng.standard_normal(200)).astype(np.float32) * 0.4
    mic = np.stack([np.convolve(np.pad(f, (d, 0))[:n], rir)[:n] for f, d in zip(far, delays)])
    return far, mic.astype(np.float32)


def test_gcc_phat_and_alignment_match_jax(rng):
    far, mic = _delayed(rng, 2, 16000, [3000, 1168])
    dj = jdelay.gcc_phat_delay(jnp.asarray(far), jnp.asarray(mic), max_delay=4000)
    dt = delay.gcc_phat_delay(torch.from_numpy(far), torch.from_numpy(mic), max_delay=4000)
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert abs(int(dt[0]) - 3000) <= 40 and abs(int(dt[1]) - 1168) <= 40
    shift = np.array([512, 0], dtype=np.int32)
    np.testing.assert_array_equal(
        delay.align_far(torch.from_numpy(far), torch.from_numpy(shift), 4000).numpy(),
        np.asarray(jdelay.align_far(jnp.asarray(far), jnp.asarray(shift), 4000)))
    aj, sj = jdelay.estimate_and_align(jnp.asarray(far), jnp.asarray(mic), max_delay=4000)
    at, st = delay.estimate_and_align(torch.from_numpy(far), torch.from_numpy(mic),
                                      max_delay=4000)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert all(int(s) % 256 == 0 for s in st)


def test_audio_io_both_ways(tmp_path, rng):
    x = (0.5 * rng.standard_normal(1000)).astype(np.float32)
    audio_io.write_wav(str(tmp_path / "a.wav"), x, 16000)
    got, sr = jio.read_wav(str(tmp_path / "a.wav"))
    assert sr == 16000
    np.testing.assert_array_equal(got, x)
    pcm = (x * 20000).astype(np.int16)
    from scipy.io import wavfile

    wavfile.write(str(tmp_path / "b.wav"), 48000, np.stack([pcm, pcm], 1))
    want, wsr = jio.read_wav(str(tmp_path / "b.wav"), sr=16000)
    got, gsr = audio_io.read_wav(str(tmp_path / "b.wav"), sr=16000)
    assert gsr == wsr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_two_layer_gru_matches_jax(rng):
    """apply and loss on JAX's weights carried over (fp32 round-off, 1e-5
    of scale); the weights round trip bit for bit; the init's shapes."""
    params = jtl.two_layer_gru_init(jax.random.PRNGKey(0))
    net = two_layer_gru_from_jax(params, device="cpu")
    back = two_layer_gru_to_jax(net)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    fresh = ttl.two_layer_gru_init(generator=torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, two_layer_gru_to_jax(fresh)) == jax.tree.map(np.shape, params)
    erb = erb_filterbank()
    mic, ref, near = (rng.standard_normal((2, 4096)).astype(np.float32) for _ in range(3))
    oj = jtl.two_layer_gru_apply(params, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb))
    with torch.no_grad():
        ot = ttl.two_layer_gru_apply(net, torch.from_numpy(mic), torch.from_numpy(ref),
                                     torch.from_numpy(erb))
    for k in ("wav", "est_erb", "mask"):
        w = np.asarray(oj[k])
        assert float(np.abs(ot[k].numpy() - w).max()) <= 1e-5 * float(np.abs(w).max()), k
    for asym in (0.0, 0.3):
        lj, _ = jtl.two_layer_gru_loss(params, *map(jnp.asarray, (mic, ref, near, erb)),
                                       asym_weight=asym, sqrt_eps=1e-12)
        lt, _ = ttl.two_layer_gru_loss(net, *map(torch.from_numpy, (mic, ref, near, erb)),
                                       asym_weight=asym, sqrt_eps=1e-12)
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)


@pytest.fixture(scope="module")
def tt_list(tmp_path_factory):
    """Two test utterances (one hop-fractional) in a grouped ``.ex`` file
    and the list naming it."""
    d = tmp_path_factory.mktemp("tt")
    rng = np.random.default_rng(7)
    utts = []
    for n in (6000, 4096):
        far, echo = _delayed(rng, 1, n, [0])
        near = (0.1 * rng.standard_normal(n)).astype(np.float32)
        utts.append({"nearend_speech": near, "nearend_mic": near + echo[0],
                     "farend_speech": far[0], "echo": echo[0]})
    path = str(d / "test.ex")
    h5io.write_grouped(path, utts)
    lst = str(d / "tt_list.txt")
    h5io.write_filelist(lst, [path])
    return lst


def _run_both(tmp_path, tt, model_file, *args):
    """The JAX CLI and the port's (on the CPU) on one list -> their
    ``near_est`` wavs per utterance, and the port's other four wavs."""
    out = {}
    for name, main, extra in (("jax", jax_infer.main, []),
                              ("port", infer.main, ["--device", "cpu"])):
        est = str(tmp_path / f"est_{name}")
        main(["--tt_list", tt, "--ckpt_dir", str(tmp_path / f"exp_{name}"),
              "--model_file", model_file, "--est_path", est, *args, *extra])
        out[name] = {f"{i}_{k}": jio.read_wav(os.path.join(est, "test", f"{i}_{k}.wav"))[0]
                     for i in range(2) for k in ("near_est", "near", "far", "mic", "echo")}
    return out


def _compare(out, rel):
    for key, want in out["jax"].items():
        got = out["port"][key]
        assert got.shape == want.shape, key
        bar = rel * max(float(np.abs(want).max()), 1e-9) if key.endswith("near_est") else 0.0
        assert float(np.abs(got - want).max()) <= bar, key


def test_infer_cli_little_net_matches_jax(tmp_path, tt_list):
    """Kalman stage 1 + LittleNet with the in-forward pseudo-norm: wavs
    within 1e-4 of scale (fp32 round-off through a 10-partition recursion
    and the net); the four copied wavs bit for bit."""
    _compare(_run_both(tmp_path, tt_list, CKPT, "--stage1", "kalman"), 1e-4)


def test_infer_cli_two_layer_gru_matches_jax(tmp_path, tt_list):
    path = str(tmp_path / "tlg.npz")
    jck.save(path, {"params": jtl.two_layer_gru_init(jax.random.PRNGKey(3))})
    _compare(_run_both(tmp_path, tt_list, path, "--model", "two_layer_gru", "--stage1", "nlms",
                       "--align-far-ms", "20"), 1e-4)


def test_infer_cli_dccrn_matches_jax(tmp_path, tt_list):
    """DccrnConfig() at full width from the port's init, saved with the
    port's checkpoints.save under {params, model_state}, restored by both
    CLIs; Kalman stage 1. Wavs within 1e-4 of scale."""
    params, state = td.dccrn_init(generator=torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "dccrn.npz")
    checkpoints.save(path, {"params": params, "model_state": state})
    _compare(_run_both(tmp_path, tt_list, path, "--model", "dccrn", "--stage1", "kalman"), 1e-4)


def test_infer_cli_fullsubnet_matches_jax(tmp_path, tt_list):
    """FullSubNetConfig() at full width from JAX's init, saved by JAX's
    checkpoints.save, restored by both CLIs; Kalman stage 1 on the CLI's
    512/256 blocks, FullSubNet's own 320/160 STFT (the hop-mismatch tail is
    padded). Wavs within 1e-4 of scale (fp32 round-off through the
    10-partition recursion and the net)."""
    path = str(tmp_path / "fsn.npz")
    jck.save(path, {"params": jfsn.fullsubnet_init(jax.random.PRNGKey(5))})
    _compare(_run_both(tmp_path, tt_list, path, "--model", "fullsubnet", "--stage1", "kalman"),
             1e-4)


@pytest.mark.slow
def test_infer_cli_att_ccrn_matches_jax(tmp_path, tt_list):
    """AttCcrnConfig() at full width (a 4096-wide bottleneck LSTM) from
    JAX's init, saved by JAX; ``--lstm_dtype auto`` is f32 off the
    accelerator on both sides. Wavs within 1e-4 of scale. Slow (~110 s):
    JAX's CPU scan at H = 4096 takes ~16 s per utterance and its init ~12 s;
    the port's model is held to JAX at narrow widths in
    tests/test_torch_att_ccrn.py."""
    params, state = jatt.att_ccrn_init(jax.random.PRNGKey(6))
    path = str(tmp_path / "att.npz")
    jck.save(path, {"params": params, "model_state": state})
    del params, state
    _compare(_run_both(tmp_path, tt_list, path, "--model", "att_ccrn", "--stage1", "kalman"),
             1e-4)


def test_infer_cli_att_ccrn_lstm_dtypes(tmp_path):
    """The ATT-CCRN enhancer on a JAX-saved full-width checkpoint (the tree
    drawn by the port's init) equals the model behind Kalman stage 1, bit for
    bit, for each ``--lstm_dtype``: auto is f32 on the CPU, int8 and bf16 the
    quantized and cast recurrences (int8 differs from f32)."""
    from aec_tpu_torch.configs import KalmanConfig
    from aec_tpu_torch.linear.kalman import kalman_cancel
    from aec_tpu_torch.models import att_ccrn as tatt

    params, state = tatt.att_ccrn_init(generator=torch.Generator().manual_seed(1), device="cpu")
    path = str(tmp_path / "att.npz")
    jck.save(path, jax.tree.map(lambda t: t.numpy(), {"params": params, "model_state": state}))
    far, mic = (torch.from_numpy(v) for v in _delayed(np.random.default_rng(9), 1, 2048, [0]))
    lin = kalman_cancel(KalmanConfig(), far, mic, block=256)["wav"]
    got = {}
    for dtype, rd in (("auto", None), ("int8", "int8"), ("bf16", torch.bfloat16)):
        enhance, _ = infer._make_enhancer("att_ccrn", path, "kalman", infer.StftConfig(),
                                          lstm_dtype=dtype, device="cpu")
        got[dtype] = enhance(far, mic)
        with torch.no_grad():
            want, _ = tatt.att_ccrn_apply(params, state, lin, far, lstm_recurrent_dtype=rd)
        assert torch.equal(got[dtype], want["wav"]), dtype
    assert float((got["int8"] - got["auto"]).abs().max()) > 0


def test_infer_refusals(tmp_path, tt_list):
    for model in ("dct_dnn", "dct_cnn"):
        with pytest.raises(NotImplementedError, match="ROADMAP A2"):
            infer._make_enhancer(model, CKPT, "none", infer.StftConfig(), device="cpu")
        with pytest.raises(SystemExit):
            infer.main(["--tt_list", tt_list, "--ckpt_dir", str(tmp_path), "--model_file", CKPT,
                        "--est_path", str(tmp_path / "e"), "--model", model, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="utils/torch_compat"):
        infer.load_params(str(tmp_path / "ref.pt"), device="cpu")
    for model in ("dccrn", "fullsubnet", "att_ccrn"):
        with pytest.raises(ValueError, match="little_net-only"):
            infer._make_enhancer(model, "x.pt", "none", infer.StftConfig(), device="cpu")


def test_infer_cli_imports_no_jax():
    code = ("import sys; sys.modules['jax'] = sys.modules['aec_tpu'] = None; "
            "from aec_tpu_torch.cli import infer; infer.main(['--help'])")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert "--align-far-ms" in res.stdout and "--device" in res.stdout
