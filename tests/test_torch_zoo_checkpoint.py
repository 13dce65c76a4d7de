"""Zoo training's checkpoints: a narrow DCCRN's {"params", "opt_state",
"model_state"} written by one package and resumed by the other (split out
of tests/test_torch_zoo_train.py; the helpers are tests/torch_zoo_common.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from aec_tpu.train import checkpoints as jck
from aec_tpu_torch.train import checkpoints as tck
from aec_tpu_torch.train import loop as tloop
from aec_tpu_torch.utils import weights
from torch_zoo_common import (
    LOSS_RTOL,
    LR,
    _assert_params_close,
    _assert_state_close,
    _assert_tree_close,
    _comparable,
    _dccrn,
    _jax_step,
    _port_step,
    _scene,
)


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
