"""Port zoo training (train.loop's Optimizer and train steps over every
family, train.generic.GenericTrainer, cli.train for every family) == JAX,
on the CPU, with JAX's weights carried across (the two packages draw their
initial weights from different generators)."""

import functools
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models import att_ccrn as jatt
from aec_tpu.models import dccrn as jdccrn
from aec_tpu.models import dct_net as jdct
from aec_tpu.models import fullsubnet as jfsn
from aec_tpu.models import two_layer_gru as jtlg
from aec_tpu.train import checkpoints as jck
from aec_tpu.train import loop as jloop
from aec_tpu.train.generic import GenericTrainer as JaxGenericTrainer
from aec_tpu.train.generic import make_adapter as jax_make_adapter
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.models import att_ccrn as tatt
from aec_tpu_torch.models import dccrn as tdccrn
from aec_tpu_torch.models import dct_net as tdct
from aec_tpu_torch.models import fullsubnet as tfsn
from aec_tpu_torch.models import two_layer_gru as ttlg
from aec_tpu_torch.models.tree_net import (
    bias_keys_before_batch_norm,
    copy_into,
    functional_params,
    model_state,
)
from aec_tpu_torch.pipeline import h5io as th5
from aec_tpu_torch.train import checkpoints as tck
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.train.generic import GenericTrainer
from aec_tpu_torch.utils import weights

ROOT = os.path.join(os.path.dirname(__file__), "..")
LR = 1e-3  # updates well above round-off
# loss at every step. DCCRN's v1 loss divides by |mic|^2 + 1e-9 in its cIRM
# target, which turns fp32 round-off in quiet bins into up to ~5e-5 relative
# between two evaluations; 1e-4 holds that with 2x headroom, and every other
# family's loss at the same bar
LOSS_RTOL = 1e-4
# BatchNorm statistics: fp32 round-off of batch means and variances, of
# each BatchNorm's scale (_assert_state_close)
STATE_REL = 1e-5
# Adam's moments accumulate three steps of gradient round-off (nu squared):
# the bar of tests/test_torch_train.py's three-step test
OPT_REL = 5e-3


def _scene(rng, b=2, n=4096):
    """mic = near + echo of far (tests/test_convergence.py's scenes)."""
    far = rng.standard_normal((b, n)).astype(np.float32)
    rir = (np.exp(-np.arange(200) / 50.0) * rng.standard_normal(200)).astype(np.float32)
    echo = np.stack([np.convolve(f, 0.3 * rir)[:n] for f in far]).astype(np.float32)
    near = (0.2 * rng.standard_normal((b, n))).astype(np.float32)
    return near + echo, far, near, echo


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_tree_close(got, want, rel, what):
    """Same leaf paths; each leaf within ``rel`` of its own scale."""
    got, want = _np_tree(got), _np_tree(want)
    assert _paths(got) == _paths(want), what
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape, (what, jax.tree_util.keystr(path))
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _assert_state_close(got, want, what):
    """Every BatchNorm statistic within STATE_REL of its BatchNorm's scale,
    the largest of that BatchNorm's statistics. A batch mean is a sum that
    cancels (down to 1e-4 of the activations' spread here), so its
    round-off follows the spread, which the variances (1 at init) measure."""
    got, want = _np_tree(got), _np_tree(want)
    assert _paths(got) == _paths(want), what
    flat = [(p, np.asarray(w), np.asarray(g)) for (p, w), g in
            zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got))]
    scale: dict = {}
    for p, w, _ in flat:
        bn = jax.tree_util.keystr(p[:-1])
        scale[bn] = max(scale.get(bn, 1e-12), float(np.abs(w).max()))
    for p, w, g in flat:
        np.testing.assert_allclose(g, w, atol=STATE_REL * scale[jax.tree_util.keystr(p[:-1])],
                                   rtol=0, err_msg=f"{what} {jax.tree_util.keystr(p)}")


def _assert_params_close(got, want, lr):
    """Every leaf of any family's tree: mean |difference| within 1e-3 x lr,
    the bar of tests/test_torch_train.py. Adam moves each element by about
    lr whatever its gradient's size, so an element whose gradient lies at
    round-off may follow its sign either way: among the millions of
    elements of a recurrent matrix a few do (up to 2 lr apart after three
    steps), and the mean bar bounds their share to 0.05 %; a wrong bias
    correction, schedule or clip moves whole leaves by ~lr."""
    got, want = _np_tree(got), _np_tree(want)
    assert _paths(got) == _paths(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)):
        d = np.abs(np.asarray(g) - np.asarray(w))
        assert d.mean() <= 1e-3 * lr, (jax.tree_util.keystr(path), d.mean(), d.max())


# ------------------------------------------------------------ the families
# Each case: JAX's (params, state) and loss_fn(p, s, mic, far, near, echo)
# -> (loss, {"state": ...}), the port's net (JAX's weights carried across)
# and its loss_fn of the same signature. Narrow widths, JAX's own branches.

def _dccrn():
    cfg_j = jdccrn.DccrnConfig(conv_channels=(4, 8, 16))
    cfg_t = tdccrn.DccrnConfig(conv_channels=(4, 8, 16))
    params, state = jdccrn.dccrn_init(jax.random.PRNGKey(0), cfg_j)
    net = weights.dccrn_from_jax(params, state, cfg_t, device="cpu")
    return (params, state,
            lambda p, s, *b: jdccrn.dccrn_loss_v1(p, s, *b, cfg_j, train=True),
            net, lambda p, s, *b: tdccrn.dccrn_loss_v1(p, s, *b, cfg_t, train=True))


def _fullsubnet():
    cfg_j = jfsn.FullSubNetConfig(fb_hidden=32, sb_hidden=16)
    cfg_t = tfsn.FullSubNetConfig(fb_hidden=32, sb_hidden=16)
    params = jfsn.fullsubnet_init(jax.random.PRNGKey(1), cfg_j)

    def jloss(p, s, mic, far, near, echo):
        return jfsn.fullsubnet_loss(p, mic, far, near, echo, cfg_j)[0], {"state": s}

    def tloss(p, s, mic, far, near, echo):
        return tfsn.fullsubnet_loss(p, mic, far, near, echo, cfg_t)[0], {"state": s}

    return params, {}, jloss, weights.fullsubnet_from_jax(params, cfg_t, device="cpu"), tloss


def _att_ccrn():
    cfg_j, cfg_t = jatt.AttCcrnConfig(channels=(1, 4, 8)), tatt.AttCcrnConfig(channels=(1, 4, 8))
    params, state = jatt.att_ccrn_init(jax.random.PRNGKey(2), cfg_j)

    def jloss(p, s, mic, far, near, echo):
        loss, aux = jatt.att_ccrn_loss(p, s, mic, far, near, cfg_j, train=True)
        return loss, {"state": aux["state"]}

    def tloss(p, s, mic, far, near, echo):
        loss, aux = tatt.att_ccrn_loss(p, s, mic, far, near, cfg_t, train=True)
        return loss, {"state": aux["state"]}

    net = weights.att_ccrn_from_jax(params, state, cfg_t, device="cpu")
    return params, state, jloss, net, tloss


def _dct(name):
    def make():
        jinit, jl = ((jdct.dnn_init, jdct.dnn_loss) if name == "dct_dnn"
                     else (jdct.cnn_init, jdct.cnn_loss))
        carry, tl = ((weights.dct_dnn_from_jax, tdct.dnn_loss) if name == "dct_dnn"
                     else (weights.dct_cnn_from_jax, tdct.cnn_loss))
        params = jinit(jax.random.PRNGKey(3))

        # the denoising contract of tests/test_convergence.py: noisy -> clean
        def jloss(p, s, mic, far, near, echo):
            return jl(p, mic, near)[0], {"state": s}

        def tloss(p, s, mic, far, near, echo):
            return tl(p, mic, near)[0], {"state": s}

        return params, {}, jloss, carry(params, device="cpu"), tloss

    return make


STATEFUL_STEP = {"dccrn": _dccrn, "fullsubnet": _fullsubnet, "att_ccrn": _att_ccrn,
                 "dct_dnn": _dct("dct_dnn"), "dct_cnn": _dct("dct_cnn")}


def _stopped(loss_fn, paths, stop):
    """``loss_fn`` with the gradient of the leaves at ``paths`` stopped."""
    def wrapped(p, *args):
        p = jax.tree_util.tree_map_with_path(
            lambda path, v: stop(v) if jax.tree_util.keystr(path) in paths else v, p)
        return loss_fn(p, *args)

    return wrapped


def _comparable(case):
    """A family's case with the pre-BatchNorm biases' gradients stopped in
    both packages, so that the steps compare leaf by leaf (those biases
    then stay at their initial values in both)."""
    params, state, jloss, net, tloss = case
    paths = bias_keys_before_batch_norm(params)
    return (params, state, _stopped(jloss, paths, jax.lax.stop_gradient), net,
            _stopped(tloss, paths, torch.Tensor.detach))


def _port_step(net, tloss, steps_per_epoch=100):
    opt = tloop.make_optimizer(TrainConfig(lr=LR), steps_per_epoch, net)
    step = tloop.make_stateful_train_step(tloss, opt)
    state = model_state(net)

    def run(batch):
        new_state, loss = step(state, *map(torch.from_numpy, batch))
        copy_into(state, new_state)
        return float(loss)

    return opt, state, run


def _jax_step(jloss):
    jopt = jloop.make_optimizer(JaxTrainConfig(lr=LR), 100)
    return jopt, jloop.make_stateful_train_step(jloss, jopt)


@pytest.mark.parametrize("family", sorted(STATEFUL_STEP))
def test_three_stateful_steps_match_jax(rng, family):
    """Three make_stateful_train_step steps (make_optimizer's Adam at lr
    1e-3) vs JAX's on one batch of 2, the pre-BatchNorm biases' gradients
    stopped in both (_comparable): the loss at every step within
    LOSS_RTOL, the BatchNorm statistics as _assert_state_close says after
    every step; then the parameters as _assert_params_close
    says and the optimizer state: optax's tree, leaf for leaf, the moments
    within OPT_REL."""
    params, state, jloss, net, tloss = _comparable(STATEFUL_STEP[family]())
    jopt, jstep = _jax_step(jloss)
    opt_state = jopt.init(params)
    opt, tstate, run = _port_step(net, tloss)
    batch = _scene(rng)
    for i in range(3):
        params, opt_state, state, jl = jstep(params, opt_state, state, *map(jnp.asarray, batch))
        tl = run(batch)
        np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL, err_msg=f"loss {i}")
        _assert_state_close(tstate, state, f"state after step {i}")
    _assert_params_close(weights.to_jax(net)[0], params, LR)
    _assert_tree_close(tloop.train_tree(opt)["opt_state"], opt_state, OPT_REL, "opt_state")


@pytest.mark.parametrize("family", ["dccrn", "att_ccrn"])
def test_pre_batchnorm_biases_have_round_off_gradients(rng, family):
    """The loss's gradient in both packages on one batch: each bias that
    feeds a BatchNorm (bias_keys_before_batch_norm) has a gradient within
    1e-5 of the largest leaf's scale in each package (fp32 round-off of an
    exact zero), which is why the step comparisons stop it."""
    params, state, jloss, net, tloss = STATEFUL_STEP[family]()
    batch = _scene(rng)
    want = _np_tree(jax.grad(lambda p: jloss(p, state, *map(jnp.asarray, batch))[0])(params))
    loss, _ = tloss(functional_params(net), model_state(net), *map(torch.from_numpy, batch))
    loss.backward()
    got = weights.param_tree(net, lambda p: p.grad.numpy() if p.grad is not None
                             else np.zeros(p.shape, np.float32))
    paths = bias_keys_before_batch_norm(params)
    assert paths
    for grads in (want, got):
        flat = {jax.tree_util.keystr(p): np.abs(v).max()
                for p, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
        top = max(flat.values())
        assert all(flat[k] <= 1e-5 * top for k in paths), {k: flat[k] / top for k in paths}


def test_three_two_layer_gru_steps_match_jax(rng):
    """TwoLayerGRU trains on the reference-cadence make_train_step in both
    packages (JAX's CLI sends it to Trainer): three steps, the loss at
    rtol 1e-5 (tests/test_torch_train.py's LittleNet bar: no BatchNorm, no
    cIRM), parameters and optimizer state as above."""
    params = jtlg.two_layer_gru_init(jax.random.PRNGKey(4))
    mic, far, near, _ = _scene(rng)
    erb = erb_filterbank()
    jopt = jloop.make_optimizer(JaxTrainConfig(lr=LR), 100)
    jstep = jloop.make_train_step(jtlg.two_layer_gru_loss, jopt)
    opt_state = jopt.init(params)
    net = weights.two_layer_gru_from_jax(params, device="cpu")
    opt = tloop.make_optimizer(TrainConfig(lr=LR), 100, net)
    step = tloop.make_train_step(ttlg.two_layer_gru_loss, opt)
    for i in range(3):
        params, opt_state, jl = jstep(params, opt_state, *map(jnp.asarray, (mic, far, near, erb)))
        tl = step(*map(torch.from_numpy, (mic, far, near, erb)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"loss {i}")
    _assert_params_close(weights.two_layer_gru_to_jax(net), params, LR)
    _assert_tree_close(tloop.train_tree(opt)["opt_state"], opt_state, OPT_REL, "opt_state")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stateful_checkpoint_resumes_across_packages(rng, tmp_path, direction):
    """{"params", "opt_state", "model_state"} of a narrow DCCRN after two
    steps, written by one package and resumed by the other; the next step
    of each from that file agrees (loss, BatchNorm state, parameters)."""
    params, state, jloss, net, tloss = _comparable(_dccrn())
    jopt, jstep = _jax_step(jloss)
    opt_state = jopt.init(params)
    opt, tstate, run = _port_step(net, tloss)
    batch = _scene(rng)
    path = str(tmp_path / "ckpt.npz")
    for _ in range(2):
        if direction == "jax_to_port":
            params, opt_state, state, _ = jstep(params, opt_state, state, *map(jnp.asarray, batch))
        else:
            run(batch)
    if direction == "jax_to_port":
        jck.save(path, {"params": params, "opt_state": opt_state, "model_state": state})
        tloop.restore_train_tree(path, opt)
        assert opt.count == 2
    else:
        tck.save(path, tloop.train_tree(opt))
        restored = jck.restore(path, {"params": params, "opt_state": opt_state,
                                      "model_state": state})
        params, opt_state, state = (restored[k] for k in ("params", "opt_state", "model_state"))
        assert int(opt_state[-1][0].count) == 2
    _assert_tree_close(weights.to_jax(net)[0], params, 0.0, "resumed params")
    _assert_tree_close(tstate, state, 0.0, "resumed state")
    params, opt_state, state, jl = jstep(params, opt_state, state, *map(jnp.asarray, batch))
    np.testing.assert_allclose(run(batch), float(jl), rtol=LOSS_RTOL)
    _assert_state_close(tstate, state, "state")
    _assert_params_close(weights.to_jax(net)[0], params, LR)


def test_trainer_takes_two_layer_gru(tmp_path, rng):
    """Trainer with the registry's two_layer_gru loss and init, as JAX's CLI
    builds it; its checkpoint restores under JAX's template."""
    from aec_tpu_torch.models.registry import get_model

    paths, cv = _make_dataset(tmp_path, rng)
    spec = get_model("two_layer_gru")
    out = tloop.Trainer(paths, cv, str(tmp_path / "exp"), cfg=TrainConfig(max_n_epochs=1,
                        batch_size=2, lr=1e-4), loss_fn=spec.loss, init_fn=spec.init,
                        device="cpu").train()
    assert isinstance(out["net"], ttlg.TwoLayerGru) and out["optimizer"].count == 1
    jparams = jtlg.two_layer_gru_init(jax.random.PRNGKey(0))
    jopt = jloop.make_optimizer(JaxTrainConfig(), 1)
    got = jck.restore(str(tmp_path / "exp/models/latest.npz"),
                      {"params": jparams, "opt_state": jopt.init(jparams)})
    _assert_tree_close(got["params"], weights.two_layer_gru_to_jax(out["net"]), 0.0, "params")


# ------------------------------------------------------------ GenericTrainer

def _make_dataset(tmp_path, rng, n_utts=2, n=4096):
    """As tests/test_generic_trainer.py: tiny per-utterance .ex files and a cv file."""
    paths = []
    for i in range(n_utts):
        mic, far, near, echo = (a[0] for a in _scene(rng, 1, n))
        p = str(tmp_path / f"tr_{i}.ex")
        th5.write_utterance(p, {"nearend_speech": near, "nearend_mic": mic,
                                "farend_speech": far, "echo": echo})
        paths.append(p)
    cv = str(tmp_path / "cv.ex")
    th5.write_grouped(cv, [th5.read_utterance(paths[0])])
    return paths, cv


# the adapters' configs narrowed for the trainer and CLI cases: DCCRN's and
# ATT-CCRN's defaults hold 34M and 134M parameters (a checkpoint with
# Adam's moments is 0.4 and 1.6 GB); make_adapter reads the config classes
# at call time
NARROW = {"dccrn": ("aec_tpu_torch.models.dccrn", "DccrnConfig", {"conv_channels": (4, 8, 16)},
                    lambda kw: jdccrn.dccrn_init(jax.random.PRNGKey(0), jdccrn.DccrnConfig(**kw))),
          "att_ccrn": ("aec_tpu_torch.models.att_ccrn", "AttCcrnConfig", {"channels": (1, 4, 8)},
                       lambda kw: jatt.att_ccrn_init(jax.random.PRNGKey(0),
                                                     jatt.AttCcrnConfig(**kw)))}


@pytest.mark.parametrize("model", ["fullsubnet", "att_ccrn", "little_net", "dccrn"])
def test_generic_trainer_one_epoch_restores_in_jax(tmp_path, rng, monkeypatch, model):
    """GenericTrainer for one epoch per family (as tests/test_generic_trainer.py
    runs JAX's; DCCRN and ATT-CCRN narrowed, NARROW); its latest.npz
    restores under JAX's {"params", "opt_state", "model_state"} template of
    the same config in JAX's checkpoints.restore, leaf for leaf."""
    if model in NARROW:
        module, name, kw, _ = NARROW[model]
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), **kw))
    paths, cv = _make_dataset(tmp_path, rng)
    metrics = ("sisdr",) if model == "dccrn" else ()
    exp = tmp_path / f"exp_{model}"
    out = GenericTrainer(model=model, tr_list=paths, cv_file=cv, ckpt_dir=str(exp),
                         cfg=TrainConfig(max_n_epochs=1, batch_size=2, lr=1e-4),
                         validate_metrics=metrics, device="cpu").train()
    info = out["ckpt_info"]
    assert info["cur_epoch"] == 1 and info["model"] == model and np.isfinite(info["cv_loss"])
    row = json.loads((exp / "metrics.jsonl").read_text().splitlines()[-1])
    assert row["model"] == model and set(row) == {"epoch", "iter", "model", "tr_loss",
                                                  "cv_loss", "batch_time_s", "train_xrt"}
    if metrics:
        assert np.isfinite(info["cv_sisdr"]) and (exp / "models/best_sisdr.npz").is_file()
    if model in NARROW:
        params, state = NARROW[model][3](NARROW[model][2])
    else:
        params, state = jax_make_adapter(model).init(jax.random.PRNGKey(0))
    jopt = jloop.make_optimizer(JaxTrainConfig(), 1)
    got = jck.restore(str(exp / "models/latest.npz"),
                      {"params": params, "opt_state": jopt.init(params), "model_state": state})
    want_p, want_s = weights.to_jax(out["net"])
    _assert_tree_close(got["params"], want_p, 0.0, "params")
    _assert_tree_close(got["model_state"], want_s, 0.0, "model_state")
    assert int(got["opt_state"][-1][0].count) == 1


def test_jax_generic_checkpoint_resumes_in_port(tmp_path, rng):
    """JAX's GenericTrainer trains FullSubNet one epoch (one step) and
    writes latest.npz; JAX and the port each resume from it for one more
    step: the same tr_loss (LOSS_RTOL) and cv loss, the parameters as
    _assert_params_close says."""
    paths, cv = _make_dataset(tmp_path, rng)
    cfg = dict(max_n_epochs=1, batch_size=2, lr=1e-3)
    JaxGenericTrainer(model="fullsubnet", tr_list=paths, cv_file=cv,
                      ckpt_dir=str(tmp_path / "j0"), cfg=JaxTrainConfig(**cfg)).train()
    latest = str(tmp_path / "j0/models/latest.npz")
    want = JaxGenericTrainer(model="fullsubnet", tr_list=paths, cv_file=cv,
                             ckpt_dir=str(tmp_path / "j1"), cfg=JaxTrainConfig(**cfg),
                             resume_model=latest).train()
    got = GenericTrainer(model="fullsubnet", tr_list=paths, cv_file=cv,
                         ckpt_dir=str(tmp_path / "t1"), cfg=TrainConfig(**cfg),
                         resume_model=latest, device="cpu").train()
    assert got["optimizer"].count == 2
    for k in ("tr_loss", "cv_loss"):
        np.testing.assert_allclose(got["ckpt_info"][k], want["ckpt_info"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    _assert_params_close(weights.to_jax(got["net"])[0], want["params"], cfg["lr"])


def test_generic_trainer_refuses_what_the_port_leaves_out(tmp_path):
    with pytest.raises(NotImplementedError, match="A6"):
        GenericTrainer("dccrn", [], "", str(tmp_path), use_mesh=True, device="cpu")
    with pytest.raises(ValueError, match="unknown validate_metrics"):
        GenericTrainer("dccrn", [], "", str(tmp_path), validate_metrics=("pesq",), device="cpu")


# ------------------------------------------------------------ the CLI

@pytest.mark.parametrize("model", ["two_layer_gru", "dccrn", "fullsubnet", "att_ccrn"])
def test_cli_trains_every_family_without_jax(tmp_path, rng, model):
    """aec_tpu_torch.cli.train's main with --model M --device cpu trains one
    epoch (DCCRN and ATT-CCRN narrowed, NARROW) with jax and the JAX package
    blocked; the checkpoint carries the family's model_state (JAX's
    GenericTrainer layout) where it has one."""
    paths, cv = _make_dataset(tmp_path, rng)
    lst = str(tmp_path / "tr_list.txt")
    th5.write_filelist(lst, paths)
    exp = str(tmp_path / "exp")
    narrow = ""
    if model in NARROW:
        module, name, kw, _ = NARROW[model]
        narrow = (f"import functools, importlib\nm = importlib.import_module({module!r})\n"
                  f"m.{name} = functools.partial(m.{name}, **{kw!r})\n")
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['aec_tpu'] = None\n"
        + narrow +
        "from aec_tpu_torch.cli.train import main\n"
        f"main(['--tr_list', {lst!r}, '--cv_file', {cv!r}, '--ckpt_dir', {exp!r},\n"
        f"      '--model', {model!r}, '--batch_size', '2', '--max_n_epochs', '1',\n"
        "      '--device', 'cpu'])\n"
        "assert not any(m.split('.')[0] in ('jax', 'aec_tpu') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    with np.load(os.path.join(exp, "models", "latest.npz")) as data:
        keys = list(data)
    assert any(k.startswith("['params']") for k in keys)
    assert any(k.startswith("['model_state']") for k in keys) == (model in ("dccrn", "att_ccrn"))
    if model != "two_layer_gru":
        assert json.loads(open(os.path.join(exp, "metrics.jsonl")).read())["model"] == model


def test_cli_refuses_device_cache_for_stateful_families(tmp_path, rng, capsys):
    """--device_cache with a GenericTrainer family exits with JAX's message;
    two_layer_gru trains on the cached corpus, as JAX's does."""
    from aec_tpu_torch.cli.train import main

    paths, cv = _make_dataset(tmp_path, rng, n_utts=1)
    lst = str(tmp_path / "l.txt")
    th5.write_filelist(lst, paths)
    base = ["--tr_list", lst, "--cv_file", cv, "--ckpt_dir", str(tmp_path), "--device", "cpu",
            "--device_cache", "int16"]
    with pytest.raises(SystemExit) as e:
        main(base + ["--model", "dccrn"])
    assert e.value.code == 2
    assert "the stateful trainer keeps the host loader" in capsys.readouterr().err
    main(base + ["--model", "two_layer_gru", "--batch_size", "1", "--max_n_epochs", "1"])
    with open(str(tmp_path / "metrics.jsonl")) as f:
        assert "epoch_time_s" in json.loads(f.readline())
    assert os.path.isfile(str(tmp_path / "models" / "latest.npz"))
