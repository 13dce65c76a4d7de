"""Port device-resident corpus (``pipeline/device_cache``) and the cached
``Trainer`` == JAX's, on the CPU.

The float32 cache reproduces the port's host-loader Trainer exactly (the
same batches in the same order, the same update math); int16 lands within
the quantization's effect; the codes are JAX's; one cached epoch matches
JAX's cached trainer from the same initial net at ``test_torch_train.py``'s
bars."""

import json
import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.pipeline import device_cache as jdc
from aec_tpu.train.loop import Trainer as JaxTrainer
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.models.little_net import little_net_loss
from aec_tpu_torch.pipeline import device_cache as dc
from aec_tpu_torch.pipeline import h5io
from aec_tpu_torch.train import loop
from aec_tpu_torch.utils.weights import params_from_jax, params_to_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_UTTS, N_CV, LEN = 12, 3, 8192


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these many small CPU ops: the suite runs
    several workers on one machine, where spinning thread pools multiply
    their time; the previous count is restored after each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """As tests/test_device_cache.py: a uniform-length corpus, so the host
    loader's per-batch bucket and the cache's one bucket agree."""
    root = tmp_path_factory.mktemp("dcache")
    rng = np.random.default_rng(0)
    files = []
    for i in range(N_UTTS):
        p = str(root / f"tr_{i}.ex")
        h5io.write_utterance(p, {k: rng.standard_normal(LEN).astype(np.float32) * 0.1
                                 for k in h5io.TRAIN_KEYS})
        files.append(p)
    cv_path = str(root / "cv.ex")
    h5io.write_grouped(cv_path, [{k: rng.standard_normal(LEN).astype(np.float32) * 0.1
                                  for k in h5io.TRAIN_KEYS} for _ in range(N_CV)])
    return files, cv_path, root


def test_float32_round_trip_is_exact(corpus):
    files, _, _ = corpus
    c = dc.from_files(files, dtype="float32", device="cpu")
    assert c.n_utts == N_UTTS and c.n_samples == LEN and c.scales["nearend_mic"] == 1.0
    want = h5io.read_utterance(files[3])
    for k, got in zip(dc.CACHE_KEYS, c.batch(torch.tensor([3]))):
        assert got.dtype == torch.float32 and got.shape == (1, LEN)
        np.testing.assert_array_equal(got[0].numpy(), want[k])


def test_int16_within_half_a_step(corpus):
    files, _, _ = corpus
    c = dc.from_files(files, dtype="int16", device="cpu")
    assert c.arrays["farend_speech"].dtype == torch.int16
    want = h5io.read_utterance(files[5])["farend_speech"]
    got = c.take("farend_speech", torch.tensor([5]))[0].numpy()
    step = c.scales["farend_speech"] / 32767.0  # one int16 step at the role's max-abs scale
    assert np.abs(got - want).max() <= 0.55 * step


@pytest.mark.parametrize("dtype", ["float32", "int16", "bfloat16"])
def test_chunked_assembly_equals_one_chunk(corpus, dtype):
    """Chunks of two rows (six copies a role through the staging buffers)
    assemble the same tensors as one chunk holding every row."""
    files, _, _ = corpus
    utts = [h5io.read_utterance(p) for p in files]
    a = dc._build(iter(utts), N_UTTS, dtype=dtype, chunk_bytes=LEN * 2 * 2, device="cpu")
    b = dc._build(iter(utts), N_UTTS, dtype=dtype, chunk_bytes=1 << 30, device="cpu")
    assert a.scales == b.scales
    for k in dc.CACHE_KEYS:
        assert torch.equal(a.arrays[k], b.arrays[k]), k
    with pytest.raises(ValueError, match="expected 13"):
        dc._build(iter(utts), N_UTTS + 1, dtype=dtype, device="cpu")


def test_codes_and_dequantize_equal_jax():
    """int16 codes (with clipping past the scale) and bfloat16 codes (round
    to nearest even, as ml_dtypes) bit for bit; the dequantized rows too."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 4096)) * 0.3).astype(np.float32)
    x[0, :3] = (0.5, -0.5, 0.25)
    scale = 0.45  # some samples past it: clipped
    got = dc._quantize(x, "int16", scale)
    want = jdc._quantize(x, "int16", scale)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dc.dequant(got, "int16", scale).numpy(),
                                  np.asarray(jdc.dequant(jax.numpy.asarray(want), "int16", scale)))
    got = dc._quantize(x, "bfloat16", 1.0)
    want = jdc._quantize(x, "bfloat16", 1.0)
    assert want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))
    np.testing.assert_array_equal(dc.dequant(got, "bfloat16", 1.0).numpy(),
                                  want.astype(np.float32))
    with pytest.raises(ValueError, match="use int16, bfloat16 or float32"):
        dc._torch_dtype("float16")


def _recording(losses):
    """little_net_loss that records each train step's loss (the steps run
    with gradients, validation without)."""
    def loss_fn(net, *args, **kw):
        loss, aux = little_net_loss(net, *args, **kw)
        if torch.is_grad_enabled():
            losses.append(float(loss.detach()))
        return loss, aux

    return loss_fn


def _train(files, cv, ckpt, cfg, losses=None, **kw):
    out = loop.Trainer(tr_list=files, cv_file=cv, ckpt_dir=ckpt, cfg=cfg, device="cpu",
                       loss_fn=_recording([] if losses is None else losses), **kw).train()
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        return out, [json.loads(line) for line in f]


def test_cached_trainer_equals_host_loader(corpus, tmp_path):
    """Two epochs of 3 steps at batch 4: float32 cache and host loader take
    the same steps, bit for bit (losses, parameters, Adam's moments);
    metrics.jsonl carries JAX's keys; checkpoints at JAX's cadence.
    The int16 cache stays within the quantization's effect."""
    files, cv, _ = corpus
    cfg = TrainConfig(lr=1e-3, batch_size=4, max_n_epochs=2)
    runs = {}
    for tag, cache in (("host", ""), ("float32", "float32"), ("int16", "int16")):
        losses = []
        runs[tag] = (*_train(files, cv, str(tmp_path / tag), cfg, losses, device_cache=cache,
                             time_log=str(tmp_path / f"{tag}.log")), losses)
    (host, host_rows, host_losses), (cached, rows, losses) = runs["host"], runs["float32"]
    assert len(losses) == len(host_losses) == 6 and losses == host_losses
    a, b = params_to_jax(cached["net"]), params_to_jax(host["net"])
    for x in a:
        for y in a[x]:
            np.testing.assert_array_equal(a[x][y], b[x][y])
    ta, tb = loop.train_tree(cached["optimizer"]), loop.train_tree(host["optimizer"])
    for (_, u), (_, v) in zip(*(jax.tree_util.tree_flatten_with_path(t["opt_state"])[0]
                                for t in (ta, tb))):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert len(rows) == len(host_rows) == 2
    for r, h in zip(rows, host_rows):
        # the same per-step and per-utterance losses, averaged as each
        # package's loop averages them: a float32 mean (JAX's cached loop)
        # against a float64 frame-weighted sum
        assert r["cv_loss"] == pytest.approx(h["cv_loss"], rel=1e-6)
        assert r["tr_loss"] == pytest.approx(h["tr_loss"], rel=1e-6)
        assert {"batch_time_s", "epoch_time_s", "train_xrt", "n_frames_per_batch"} <= set(r)
        assert r["n_frames_per_batch"] == 32 and r["iter"] == 2
    for f in ("latest.npz", "best_loss.npz", "latest.json"):
        assert os.path.isfile(str(tmp_path / "float32" / "models" / f)), f
    with open(str(tmp_path / "float32.log")) as f:
        assert sum(1 for _ in f) == 6
    q_losses = runs["int16"][2]
    for q, h in zip(q_losses, host_losses):
        assert abs(q - h) <= 5e-2 * max(1.0, abs(h))  # JAX's int16 bar
    assert q_losses != host_losses


def test_one_cached_epoch_matches_jax(tmp_path):
    """The same initial net (JAX's, carried into the port through init_fn)
    through one float32-cached epoch of 3 steps at lr 1e-3 in both
    packages, on echo scenes built as test_torch_train.py builds its batch
    (mic = near + the far end through a decaying path): tr / cv loss at
    rtol 1e-5, parameters as test_torch_train._assert_params_close holds
    them."""
    rng = np.random.default_rng(6)
    rir = (np.exp(-np.arange(300) / 60.0) * rng.standard_normal(300)).astype(np.float32)
    utts = []
    for _ in range(N_UTTS + N_CV):
        far = rng.standard_normal(LEN).astype(np.float32)
        echo = np.convolve(far, 0.4 * rir)[:LEN].astype(np.float32)
        near = (0.3 * rng.standard_normal(LEN)).astype(np.float32)
        utts.append({"nearend_speech": near, "nearend_mic": near + echo, "farend_speech": far,
                     "echo": echo})
    files = [str(tmp_path / f"tr_{i}.ex") for i in range(N_UTTS)]
    for p, u in zip(files, utts):
        h5io.write_utterance(p, u)
    cv = str(tmp_path / "cv.ex")
    h5io.write_grouped(cv, utts[N_UTTS:])
    init = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0)))
    jckpt = str(tmp_path / "jax")
    JaxTrainer(tr_list=files, cv_file=cv, ckpt_dir=jckpt, device_cache="float32",
               cfg=JaxTrainConfig(lr=1e-3, batch_size=4, max_n_epochs=1),
               init_fn=lambda key: jax.tree.map(jax.numpy.asarray, init)).train()
    out, rows = _train(files, cv, str(tmp_path / "port"),
                       TrainConfig(lr=1e-3, batch_size=4, max_n_epochs=1),
                       device_cache="float32",
                       init_fn=lambda generator, device: params_from_jax(init, device=device))
    with open(os.path.join(jckpt, "metrics.jsonl")) as f:
        (want,) = [json.loads(line) for line in f]
    for key in ("tr_loss", "cv_loss"):
        assert rows[0][key] == pytest.approx(want[key], rel=1e-5), key
    from aec_tpu.train import checkpoints as jck

    jparams = jck.restore(os.path.join(jckpt, "models", "latest.npz"), {"params": init})["params"]
    got = params_to_jax(out["net"])
    for a in jparams:
        for b in jparams[a]:
            d = np.abs(got[a][b] - jparams[a][b])
            assert d.mean() <= 1e-3 * 1e-3 and d.max() <= 0.25 * 1e-3, (a, b)


def test_cached_trainer_guards(corpus, tmp_path):
    files, cv, _ = corpus
    with pytest.raises(ValueError, match="validate_metrics need per-utterance wav readback"):
        loop.Trainer(files, cv, str(tmp_path / "g1"), validate_metrics=("stoi",),
                     device_cache="int16", device="cpu").train()
    with pytest.raises(ValueError, match="device_cache dtype 'int8'"):
        loop.Trainer(files, cv, str(tmp_path / "g2"), device_cache="int8", device="cpu").train()


def test_cli_trains_from_the_cache_without_jax(corpus, tmp_path):
    """python -m aec_tpu_torch.cli.train --device_cache float32 --device cpu
    with jax and the JAX package blocked; the stateful families still exit
    with JAX's message."""
    files, cv, _ = corpus
    lst = str(tmp_path / "tr_list.txt")
    h5io.write_filelist(lst, files)
    exp = str(tmp_path / "exp")
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['aec_tpu'] = None\n"
        "from aec_tpu_torch.cli.train import main\n"
        f"main(['--tr_list', {lst!r}, '--cv_file', {cv!r}, '--ckpt_dir', {exp!r},\n"
        "      '--batch_size', '4', '--max_n_epochs', '1', '--device_cache', 'float32',\n"
        "      '--device', 'cpu'])\n"
        "assert not any(m.split('.')[0] in ('jax', 'aec_tpu') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(ROOT), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        assert "epoch_time_s" in json.loads(f.readline())
    res = subprocess.run(
        [sys.executable, "-m", "aec_tpu_torch.cli.train", "--tr_list", lst, "--cv_file", cv,
         "--ckpt_dir", exp, "--model", "dccrn", "--device_cache", "int16"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "the stateful trainer keeps the host loader" in res.stderr
