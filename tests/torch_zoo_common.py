"""Helpers of the port's zoo training tests (tests/test_torch_zoo_*.py):
the families' cases, the steps of both packages, the bars, the datasets.
Split out of tests/test_torch_zoo_train.py so that ``--dist loadfile``
spreads its tests over the workers; every test and bar is as it was."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models import att_ccrn as jatt
from aec_tpu.models import dccrn as jdccrn
from aec_tpu.models import dct_net as jdct
from aec_tpu.models import fullsubnet as jfsn
from aec_tpu.train import loop as jloop
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.models import att_ccrn as tatt
from aec_tpu_torch.models import dccrn as tdccrn
from aec_tpu_torch.models import dct_net as tdct
from aec_tpu_torch.models import fullsubnet as tfsn
from aec_tpu_torch.models.tree_net import (
    bias_keys_before_batch_norm,
    copy_into,
    model_state,
)
from aec_tpu_torch.pipeline import h5io as th5
from aec_tpu_torch.train import loop as tloop
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


def three_stateful_steps(rng, family):
    """The body of each family's test_three_stateful_steps_match_jax."""
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


# ------------------------------------------------------------ GenericTrainer and CLI datasets

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
