"""Port training (aec_tpu_torch.train, models.little_net loss/init,
pipeline.h5io/datasets, cli.train) == JAX, on the CPU."""

import dataclasses
import os
import subprocess
import sys

import h5py
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.models.little_net import little_net_loss as jax_loss
from aec_tpu.pipeline import datasets as jds
from aec_tpu.pipeline import h5io as jh5
from aec_tpu.train import checkpoints as jck
from aec_tpu.train import loop as jloop
from aec_tpu.train import metrics as jmetrics
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.models.little_net import little_net_init, little_net_loss, param_count
from aec_tpu_torch.pipeline import datasets as tds
from aec_tpu_torch.pipeline import h5io as th5
from aec_tpu_torch.train import checkpoints as tck
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.train import metrics as tmetrics
from aec_tpu_torch.utils.weights import params_from_jax, params_to_jax, tree_from_named

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _batch(rng, b=2, n=4096):
    """mic = near + echo of far, as tests/test_train.py builds its scenes."""
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (np.exp(-np.arange(300) / 60.0) * rng.standard_normal(300)).astype(np.float32)
    echo = np.stack([np.convolve(far[i], 0.4 * rir)[:n] for i in range(b)]).astype(np.float32)
    near = (0.3 * rng.standard_normal((b, n))).astype(np.float32)
    return near + echo, far, near


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, rel, what):
    """Leaf by leaf, within ``rel`` of the leaf's own scale."""
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)):
        w, g = np.asarray(w), np.asarray(g)
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _assert_params_close(got, want, lr):
    """Adam moves each parameter by about ``lr`` per step whatever its
    gradient's size, so an element whose gradient is tiny (or changes sign)
    turns the gradient's fp32 round-off into an O(lr) difference. Bar: the
    mean difference of every leaf within 1e-3 x lr, no element off by a
    quarter of an update (a wrong bias correction, schedule or clip moves
    whole leaves by ~lr)."""
    for a in want:
        for b in want[a]:
            d = np.abs(np.asarray(got[a][b]) - np.asarray(want[a][b]))
            assert d.mean() <= 1e-3 * lr and d.max() <= 0.25 * lr, (a, b, d.mean(), d.max())


def test_train_config_restates_jax_config():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())


@pytest.mark.parametrize("kw", [{}, {"asym_weight": 0.5}, {"gain_norm": True},
                                {"sisnr_weight": 1.0}])
def test_loss_and_gradients_match_jax(rng, kw):
    """little_net_loss and every parameter's gradient vs JAX's
    value_and_grad, weights carried across through params_from_jax: loss at
    rtol 1e-5, each gradient leaf within 1e-4 of its scale (fp32 round-off
    through STFT, GRU and its backward, and iSTFT for the waveform terms)."""
    params = jax_init(jax.random.PRNGKey(2))
    mic, ref, near = _batch(rng)
    near[1] = 0.0  # a silent near end: no sisnr term for that scene
    erb = erb_filterbank()

    def lf(p):
        return jax_loss(p, *map(jnp.asarray, (mic, ref, near, erb)), sqrt_eps=1e-12, **kw)[0]

    want, want_g = jax.value_and_grad(lf)(params)
    net = params_from_jax(_np_tree(params), device="cpu")
    loss, aux = little_net_loss(net, *map(torch.from_numpy, (mic, ref, near, erb)),
                                sqrt_eps=1e-12, **kw)
    loss.backward()
    assert aux["wav"].shape == mic.shape
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got_g = tree_from_named({name: p.grad.numpy() for name, p in net.named_parameters()})
    _assert_tree_close(got_g, _np_tree(want_g), 1e-4, "grad")


def test_little_net_init_policy_and_size():
    """One seed, one net on every call; zero linear biases; kaiming bounds;
    the JAX package's parameter counts at widths 1, 2 and 4."""
    nets = [little_net_init(generator=torch.Generator().manual_seed(3), device="cpu")
            for _ in range(2)]
    for (name, a), (_, b) in zip(nets[0].named_parameters(), nets[1].named_parameters()):
        assert torch.equal(a, b), name
    net = nets[0]
    assert float(net.linear1.bias.abs().max()) == 0 and float(net.linear2.bias.abs().max()) == 0
    assert float(net.linear1.weight.abs().max()) <= np.sqrt(2.0) * np.sqrt(3.0 / 64)
    assert float(net.linear2.weight.abs().max()) <= np.sqrt(3.0 / 32)
    for width in (1, 2, 4):
        jp = jax_init(jax.random.PRNGKey(0), width=width)
        want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
        assert param_count(little_net_init(width=width, device="cpu")) == want


def test_lr_schedule_matches_jax():
    cfg = TrainConfig(lr=1e-5, lr_decay_factor=0.5, lr_decay_period=5)
    mine = tloop.make_lr_schedule(cfg, steps_per_epoch=10)
    theirs = jloop.make_lr_schedule(JaxTrainConfig(), steps_per_epoch=10)
    for step in (0, 1, 49, 50, 99, 100, 1000):
        assert mine(step) == pytest.approx(float(theirs(step)), rel=1e-6)


@pytest.mark.parametrize("clip_norm", [-1.0, 0.5])
def test_three_train_steps_match_jax(rng, clip_norm):
    """Three make_train_step steps vs JAX's at lr 1e-3 (updates well above
    round-off), with and without global-norm clipping (0.5 clips every
    step here): losses at rtol 1e-5, parameters as _assert_params_close
    says."""
    cfg = TrainConfig(lr=1e-3, clip_norm=clip_norm)
    jcfg = JaxTrainConfig(lr=1e-3, clip_norm=clip_norm)
    params = jax_init(jax.random.PRNGKey(4))
    mic, ref, near = _batch(rng)
    erb = erb_filterbank()
    jopt = jloop.make_optimizer(jcfg, steps_per_epoch=100)
    jstep = jloop.make_train_step(jax_loss, jopt)
    opt_state = jopt.init(params)
    jp = params
    net = params_from_jax(_np_tree(params), device="cpu")
    opt = tloop.make_optimizer(cfg, 100, net)
    step = tloop.make_train_step(little_net_loss, opt)
    for i in range(3):
        jp, opt_state, jl = jstep(jp, opt_state, *map(jnp.asarray, (mic, ref, near, erb)))
        tl = step(*map(torch.from_numpy, (mic, ref, near, erb)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"loss {i}")
    _assert_params_close(params_to_jax(net), _np_tree(jp), cfg.lr)
    # Adam's moments accumulate three steps of gradient round-off (nu squared)
    _assert_tree_close(tloop.train_tree(opt)["opt_state"], _np_tree(opt_state), 5e-3, "opt_state")


def test_metrics_match_jax(rng):
    est, target = rng.standard_normal((2, 3, 5000)).astype(np.float32)
    target[1] *= 0.1
    for name, args in (("si_snr", (est, target)), ("erle", (target, est)),
                       ("erle_segments", (target, est)), ("snr", (est, target))):
        want = np.asarray(getattr(jmetrics, name)(*map(jnp.asarray, args)))
        got = getattr(tmetrics, name)(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def _port_trained(rng, clip_norm=-1.0, steps=2):
    cfg = TrainConfig(lr=1e-3, clip_norm=clip_norm)
    net = little_net_init(generator=torch.Generator().manual_seed(5), device="cpu")
    opt = tloop.make_optimizer(cfg, 100, net)
    step = tloop.make_train_step(little_net_loss, opt)
    mic, ref, near = _batch(rng)
    erb = erb_filterbank()
    for _ in range(steps):
        step(*map(torch.from_numpy, (mic, ref, near, erb)))
    return cfg, opt, (mic, ref, near, erb)


@pytest.mark.parametrize("clip_norm", [-1.0, 1.0])
def test_port_checkpoint_restores_in_jax(rng, tmp_path, clip_norm):
    """The port's {"params", "opt_state"} restores through the JAX
    package's own restore into optax's state, leaf for leaf."""
    cfg, opt, _ = _port_trained(rng, clip_norm)
    path = str(tmp_path / "port.npz")
    tck.save(path, tloop.train_tree(opt), {"cur_epoch": 1})
    params = jax_init(jax.random.PRNGKey(0))
    jopt = jloop.make_optimizer(JaxTrainConfig(lr=1e-3, clip_norm=clip_norm), 100)
    restored = jck.restore(path, {"params": params, "opt_state": jopt.init(params)})
    assert jck.load_info(path) == {"cur_epoch": 1}
    _assert_tree_close(restored["params"], params_to_jax(opt.net), 0.0, "params")
    adam = restored["opt_state"][-1][0]
    assert int(adam.count) == 2 and int(restored["opt_state"][-1][1].count) == 2
    mine = tloop.train_tree(opt)["opt_state"][-1][0]
    _assert_tree_close(adam.mu, mine.mu, 0.0, "mu")
    _assert_tree_close(adam.nu, mine.nu, 0.0, "nu")


def test_jax_checkpoint_resumes_in_port(rng, tmp_path):
    """JAX trains two steps and saves; the port resumes from that file and
    its next step equals JAX's next step (loss rtol 1e-5, parameters as
    _assert_params_close says)."""
    params = jax_init(jax.random.PRNGKey(6))
    mic, ref, near = _batch(rng)
    erb = erb_filterbank()
    args = tuple(map(jnp.asarray, (mic, ref, near, erb)))
    jopt = jloop.make_optimizer(JaxTrainConfig(lr=1e-3), 100)
    jstep = jloop.make_train_step(jax_loss, jopt)
    opt_state = jopt.init(params)
    for _ in range(2):
        params, opt_state, _ = jstep(params, opt_state, *args)
    path = str(tmp_path / "jax.npz")
    jck.save(path, {"params": params, "opt_state": opt_state})

    net = little_net_init(generator=torch.Generator().manual_seed(9), device="cpu")
    opt = tloop.make_optimizer(TrainConfig(lr=1e-3), 100, net)
    tloop.restore_train_tree(path, opt)
    assert opt.count == 2
    _assert_tree_close(params_to_jax(net), _np_tree(params), 0.0, "restored params")
    params, opt_state, jl = jstep(params, opt_state, *args)
    tl = tloop.make_train_step(little_net_loss, opt)(*map(torch.from_numpy, (mic, ref, near, erb)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params_close(params_to_jax(net), _np_tree(params), 1e-3)


def test_latest_best_cadence(tmp_path, rng):
    _, opt, _ = _port_trained(rng, steps=1)
    tree = tloop.train_tree(opt)
    d = str(tmp_path / "models")
    tck.save_latest_best(d, tree, {"cur_epoch": 0}, True, extra_best={"best_stoi": False})
    assert sorted(os.listdir(d)) == ["best_loss.json", "best_loss.npz", "latest.json",
                                     "latest.npz"]
    back = tck.restore(os.path.join(d, "best_loss.npz"), tree)
    _assert_tree_close(back, tree, 0.0, "best")
    with pytest.raises(KeyError):
        tck.restore(os.path.join(d, "latest.npz"), {"missing": np.zeros(1)})


def _h5_layout(path):
    out = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.append(
            (name, type(obj).__name__, getattr(obj, "dtype", None), getattr(obj, "shape", None),
             getattr(obj, "chunks", None))))
    return out


def test_h5_files_cross_read(tmp_path, rng):
    """Files the port writes read back through JAX's h5io and the other
    way, with the same layout (names, dtypes, shapes, chunking)."""
    utts = [{k: rng.standard_normal(1000 + 10 * i).astype(np.float32) for k in th5.TRAIN_KEYS}
            for i in range(3)]
    val = [dict(zip(th5.VAL_KEYS, (u[k] for k in th5.TRAIN_KEYS))) for u in utts]
    for writer, reader, tag in ((th5, jh5, "port"), (jh5, th5, "jax")):
        one, grp, vgrp = (str(tmp_path / f"{tag}_{n}.ex") for n in ("one", "grp", "val"))
        lst = str(tmp_path / f"{tag}_list.txt")
        writer.write_utterance(one, utts[0])
        assert writer.write_grouped(grp, utts) == 3
        writer.write_grouped(vgrp, val, keys=writer.VAL_KEYS)
        writer.write_filelist(lst, [one, grp])
        assert reader.read_filelist(lst) == [one, grp]
        assert reader.utterance_length(one) == 1000
        for k, v in reader.read_utterance(one).items():
            np.testing.assert_array_equal(v, utts[0][k])
        assert reader.group_count(grp) == 3
        for k, v in reader.read_group(grp, 2).items():
            np.testing.assert_array_equal(v, utts[2][k])
        for k, v in reader.read_group(vgrp, 1, keys=reader.VAL_KEYS).items():
            np.testing.assert_array_equal(v, val[1][k])
    for n in ("one", "grp", "val"):
        assert _h5_layout(str(tmp_path / f"port_{n}.ex")) == _h5_layout(str(tmp_path / f"jax_{n}.ex"))


def _make_dataset(tmp_path, rng, n_utts=4, n=4096):
    """As tests/test_train.py: tiny per-utterance .ex files and a cv file."""
    paths = []
    for i in range(n_utts):
        mic, far, near = (a[0] for a in _batch(rng, 1, n))
        utt = {"nearend_speech": near, "nearend_mic": mic, "farend_speech": far,
               "echo": mic - near}
        p = str(tmp_path / f"tr_{i}.ex")
        th5.write_utterance(p, utt)
        paths.append(p)
    cv = str(tmp_path / "cv.ex")
    th5.write_grouped(cv, [th5.read_utterance(paths[0]), th5.read_utterance(paths[1])])
    return paths, cv


def test_loaders_give_jax_batches_in_jax_order(tmp_path, rng):
    paths, cv = _make_dataset(tmp_path, rng, n_utts=5)
    mine, theirs = tds.TrainLoader(paths, 2, seed=3), jds.TrainLoader(paths, 2, seed=3)
    for _ in range(2):  # two epochs: the shuffle stream goes on alike
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and a["n_samples"] == b["n_samples"]
            for k in tds.BATCH_KEYS:
                np.testing.assert_array_equal(a[k], b[k])
    got = list(tds.EvalLoader(cv, batch_size=1))
    want = list(jds.EvalLoader(cv, batch_size=1))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a["n_samples"] == b["n_samples"]
        np.testing.assert_array_equal(a["nearend_mic"], b["nearend_mic"])
    with pytest.raises(ValueError):
        tds.collate([{k: np.zeros(10, np.float32) for k in tds.BATCH_KEYS}], pad_to=5)


def test_trainer_end_to_end_and_resume(tmp_path, rng):
    """Trainer.train() on the CPU for two epochs, then a resume from its
    latest checkpoint into a third (tests/test_train.py:47-107)."""
    paths, cv = _make_dataset(tmp_path, rng)
    cfg = TrainConfig(max_n_epochs=2, batch_size=2, lr=1e-4, seed=0)
    out = tloop.Trainer(tr_list=paths, cv_file=cv, ckpt_dir=str(tmp_path / "exp"), cfg=cfg,
                        validate_metrics=("sisdr",), device="cpu").train()
    info = out["ckpt_info"]
    assert info["cur_epoch"] == 2 and info["cv_loss"] is not None
    assert np.isfinite(info["cv_sisdr"]) and info["best_sisdr"] >= info["cv_sisdr"]
    for f in ("models/latest.npz", "models/best_loss.npz", "models/best_sisdr.npz", "loss.txt",
              "metrics.jsonl", "train.log"):
        assert os.path.isfile(str(tmp_path / "exp" / f)), f
    assert out["optimizer"].count == 4  # 2 epochs x 2 steps
    latest = str(tmp_path / "exp/models/latest.npz")
    jax_view = jck.restore(latest, {"params": jax_init(jax.random.PRNGKey(0))})
    _assert_tree_close(jax_view["params"], params_to_jax(out["net"]), 0.0, "latest")

    cfg3 = TrainConfig(max_n_epochs=3, batch_size=2, lr=1e-4, seed=0)
    out3 = tloop.Trainer(paths, cv, str(tmp_path / "exp2"), cfg=cfg3, resume_model=latest,
                         device="cpu").train()
    # latest.npz is written inside epoch 2, before the epoch count moves on,
    # so the resume runs epoch 2 again, then 3 (as the JAX trainer does)
    assert out3["ckpt_info"]["cur_epoch"] == 3 and out3["optimizer"].count == 8


def test_trainer_refuses_what_the_port_leaves_out(tmp_path):
    """JAX's guards: unknown validate_metrics; a device cache with a mesh
    (aec_tpu/train/loop.py:214-215) or with validate_metrics, or of another
    dtype, before any file is read. A mesh alone is taken (several ranks:
    tests/test_torch_parallel_cli.py)."""
    assert tloop.Trainer([], "", str(tmp_path), use_mesh=True, device="cpu").use_mesh
    with pytest.raises(ValueError, match="device_cache is single-host/single-chip"):
        tloop.Trainer([], "", str(tmp_path), use_mesh=True, device_cache="int16",
                      device="cpu").train()
    with pytest.raises(ValueError, match="unknown validate_metrics"):
        tloop.Trainer([], "", str(tmp_path), validate_metrics=("pesq",), device="cpu")
    # JAX's device-cache guards (aec_tpu/train/loop.py:213-221), before any file is read
    with pytest.raises(ValueError, match="validate_metrics need per-utterance wav readback"):
        tloop.Trainer([], "", str(tmp_path), validate_metrics=("stoi",), device_cache="int16",
                      device="cpu").train()
    with pytest.raises(ValueError, match="device_cache dtype 'float16': use int16, bfloat16"):
        tloop.Trainer([], "", str(tmp_path), device_cache="float16", device="cpu").train()


def test_cli_trains_on_the_cpu_without_jax(tmp_path, rng):
    """python -m aec_tpu_torch.cli.train --device cpu on tiny files, with
    jax and the JAX package blocked; chip_smoke imports there too; the same
    process then trains with --mesh (no coordinator: a 1 x 1 mesh) to the
    same checkpoint; it also trains from an int16 device cache (every
    family trains: tests/test_torch_zoo_*.py; the cache:
    tests/test_torch_device_cache.py; --mesh on several ranks:
    tests/test_torch_parallel_cli.py)."""
    paths, cv = _make_dataset(tmp_path, rng, n_utts=2)
    lst = str(tmp_path / "tr_list.txt")
    th5.write_filelist(lst, paths)
    exp = str(tmp_path / "exp")
    meshed = str(tmp_path / "meshed")
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['aec_tpu'] = None\n"
        "import chip_smoke\n"
        "from aec_tpu_torch.cli.train import main\n"
        f"for ckpt, extra in (({exp!r}, []), ({meshed!r}, ['--mesh'])):\n"
        f"    main(['--tr_list', {lst!r}, '--cv_file', {cv!r}, '--ckpt_dir', ckpt,\n"
        "          '--batch_size', '2', '--max_n_epochs', '1', '--device', 'cpu', *extra])\n"
        "assert not any(m.split('.')[0] in ('jax', 'aec_tpu') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    # one intra-op thread: the run shares the cores with the suite's workers
    env = {**os.environ, "PYTHONPATH": os.path.abspath(ROOT), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    assert os.path.isfile(os.path.join(exp, "models", "latest.npz"))
    with np.load(os.path.join(exp, "models", "latest.npz")) as a, \
            np.load(os.path.join(meshed, "models", "latest.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cached = str(tmp_path / "cached")
    res = subprocess.run(
        [sys.executable, "-m", "aec_tpu_torch.cli.train", "--tr_list", lst, "--cv_file", cv,
         "--ckpt_dir", cached, "--batch_size", "2", "--max_n_epochs", "1", "--device_cache",
         "int16", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert os.path.isfile(os.path.join(cached, "models", "latest.npz"))
    with open(os.path.join(cached, "metrics.jsonl")) as f:
        assert "epoch_time_s" in f.readline()
