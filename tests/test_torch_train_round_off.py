"""ROADMAP C3: where one LittleNet step on random-role noise moves gru.b_hh
apart in the port and in JAX, the gradients are fp32 round-off of zero in
both packages (Adam's eps regime), not a fault of the port."""

import numpy as np
import jax
import torch

from aec_tpu.configs import TrainConfig as JaxTrainConfig
from aec_tpu.models.little_net import little_net_init as jax_init
from aec_tpu.models.little_net import little_net_loss as jax_loss
from aec_tpu.train import loop as jloop
from aec_tpu_torch.configs import TrainConfig
from aec_tpu_torch.dsp.erb import erb_filterbank
from aec_tpu_torch.models.little_net import little_net_loss
from aec_tpu_torch.pipeline import h5io as th5
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.utils.weights import params_from_jax, params_to_jax


def test_b_hh_on_random_role_noise_is_adam_eps_round_off():
    """ROADMAP C3: on random-role noise (each role independent 0.1 N(0, 1),
    tests/test_torch_device_cache.py's corpus, its first cached batch of 4
    x 8192) a step moves some elements of gru.b_hh more than 1e-3 lr apart
    in the two packages. Each such element's gradient lies in Adam's eps
    regime in both packages (|g| <= 10 eps = 1e-7, where the update
    lr g / (|g| + eps) follows g's value, not its sign) and the two
    gradients agree within fp32 round-off (1e-6 of the leaf's scale, as
    every element of the leaf does): round-off, not a fault of the port."""
    rng = np.random.default_rng(0)
    roles = ("nearend_mic", "farend_speech", "nearend_speech", "echo")
    utts = [{k: rng.standard_normal(8192).astype(np.float32) * 0.1 for k in th5.TRAIN_KEYS}
            for _ in range(12)]
    order = np.arange(12)
    np.random.default_rng(0).shuffle(order)  # the cached epoch's shuffle stream
    mic, ref, near = (np.stack([utts[i][k] for i in order[:4]]) for k in roles[:3])
    erb = erb_filterbank()
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0)))
    jg = np.asarray(jax.grad(lambda p: jax_loss(p, mic, ref, near, erb, sqrt_eps=1e-12)[0])(
        params)["gru"]["b_hh"])
    jopt = jloop.make_optimizer(JaxTrainConfig(lr=1e-3), 100)
    jp, _, _ = jloop.make_train_step(jax_loss, jopt)(params, jopt.init(params), mic, ref, near,
                                                     erb)
    net = params_from_jax(params, device="cpu")
    tloop.make_train_step(little_net_loss, tloop.make_optimizer(TrainConfig(lr=1e-3), 100, net))(
        *map(torch.from_numpy, (mic, ref, near, erb)))
    tg = net.gru1.bias_hh_l0.grad.numpy()
    scale = np.abs(jg).max()
    assert np.abs(tg - jg).max() <= 1e-6 * scale
    d = np.abs(params_to_jax(net)["gru"]["b_hh"] - np.asarray(jp["gru"]["b_hh"]))
    apart = np.nonzero(d > 1e-3 * 1e-3)[0]
    assert len(apart), "the data no longer shows C3"
    assert np.abs(jg[apart]).max() <= 1e-7 and np.abs(tg[apart]).max() <= 1e-7, apart
