"""Weights carried over from the JAX package (aec_tpu_torch.utils.weights)."""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aec_tpu.dsp.erb import erb_filterbank
from aec_tpu.models.little_net import little_net_apply as jax_apply
from aec_tpu.models.little_net import little_net_init
from aec_tpu.train import checkpoints
from aec_tpu_torch.models.little_net import little_net_apply
from aec_tpu_torch.utils.weights import load_npz, params_from_jax

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
CKPTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CKPT_DIR, "little_net_*.npz")))
WIDTHS = {"little_net_dtalk_w2.npz": 2, "little_net_dtalk_w4.npz": 4,
          "little_net_dtalk_w4_long.npz": 4}


def test_all_shipped_checkpoints_listed():
    assert len(CKPTS) == 8


@pytest.mark.parametrize("name", CKPTS)
def test_load_npz_matches_jax_restore(name):
    path = os.path.join(CKPT_DIR, name)
    width = WIDTHS.get(name, 1)
    net = load_npz(path, device="cpu")
    assert net.hidden == 32 * width
    want = checkpoints.restore(
        path, {"params": little_net_init(jax.random.PRNGKey(0), width=width)}
    )["params"]
    sd = net.state_dict()
    pairs = {
        "gru1.weight_ih_l0": want["gru"]["w_ih"], "gru1.weight_hh_l0": want["gru"]["w_hh"],
        "gru1.bias_ih_l0": want["gru"]["b_ih"], "gru1.bias_hh_l0": want["gru"]["b_hh"],
        "linear1.weight": want["lin1"]["w"], "linear1.bias": want["lin1"]["b"],
        "linear2.weight": want["lin2"]["w"], "linear2.bias": want["lin2"]["b"],
    }
    assert set(sd) == set(pairs)  # the reference's module names, nothing else
    for key, leaf in pairs.items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(leaf))


def test_load_npz_missing_file():
    with pytest.raises(FileNotFoundError):
        load_npz(os.path.join(CKPT_DIR, "no_such_checkpoint.npz"), device="cpu")


@pytest.mark.parametrize("width", [1, 2])
def test_params_from_jax_same_forward(rng, width):
    jp = little_net_init(jax.random.PRNGKey(11), width=width)
    net = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    erb = erb_filterbank()
    mic = rng.standard_normal((2, 12 * 256)).astype(np.float32)
    ref = rng.standard_normal((2, 12 * 256)).astype(np.float32)
    want = np.asarray(jax_apply(jp, jnp.asarray(mic), jnp.asarray(ref), jnp.asarray(erb),
                                precision=jax.lax.Precision.HIGHEST)["wav"])
    with torch.no_grad():
        got = little_net_apply(net, torch.from_numpy(mic), torch.from_numpy(ref),
                               torch.from_numpy(erb))["wav"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
