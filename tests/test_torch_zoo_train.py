"""Port zoo training (train.loop's Optimizer and train steps over every
family) == JAX, on the CPU, with JAX's weights carried across (the two
packages draw their initial weights from different generators). The
three-step test of DCCRN, FullSubNet, ATT-CCRN and the DCT CNN runs from
files of its own (tests/test_torch_zoo_step_*.py), GenericTrainer and
the checkpoints from tests/test_torch_zoo_trainer.py, the CLI from
tests/test_torch_zoo_cli.py; the helpers are tests/torch_zoo_common.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models import two_layer_gru as jtlg
from aec_tpu.train import loop as jloop
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.models import two_layer_gru as ttlg
from aec_tpu_torch.models.tree_net import (
    bias_keys_before_batch_norm,
    functional_params,
    model_state,
)
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.utils import weights
from torch_zoo_common import (
    LR,
    OPT_REL,
    STATEFUL_STEP,
    _assert_params_close,
    _assert_tree_close,
    _np_tree,
    _scene,
    three_stateful_steps,
)


@pytest.mark.parametrize("family", ["dct_dnn"])
def test_three_stateful_steps_match_jax(rng, family):
    """Three make_stateful_train_step steps (make_optimizer's Adam at lr
    1e-3) vs JAX's on one batch of 2, the pre-BatchNorm biases' gradients
    stopped in both (_comparable): the loss at every step within
    LOSS_RTOL, the BatchNorm statistics as _assert_state_close says after
    every step; then the parameters as _assert_params_close
    says and the optimizer state: optax's tree, leaf for leaf, the moments
    within OPT_REL."""
    three_stateful_steps(rng, family)


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
