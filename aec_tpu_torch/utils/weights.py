"""Weights carried over from the JAX package.

The JAX LittleNet parameter tree (``aec_tpu/models/little_net.py``) already
uses torch's layouts: the GRU stacks its gates [r; z; n] with separate
input/hidden biases as ``torch.nn.GRU`` does, and the linear weights are
(out, in). So the mapping is a copy, leaf by leaf.

Checkpoints (``checkpoints/little_net_*.npz``) store leaves keyed by their
tree path, e.g. ``['params']['gru']['w_ih']`` (``aec_tpu/train/
checkpoints.py``); :func:`load_npz` reads them with numpy alone and, like
the JAX restore, ignores extra entries such as optimizer state.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from aec_tpu_torch.models.little_net import LittleNet

_LEAVES = {
    ("gru", "w_ih"): "gru1.weight_ih_l0",
    ("gru", "w_hh"): "gru1.weight_hh_l0",
    ("gru", "b_ih"): "gru1.bias_ih_l0",
    ("gru", "b_hh"): "gru1.bias_hh_l0",
    ("lin1", "w"): "linear1.weight",
    ("lin1", "b"): "linear1.bias",
    ("lin2", "w"): "linear2.weight",
    ("lin2", "b"): "linear2.bias",
}


def params_from_jax(tree) -> LittleNet:
    """JAX LittleNet param tree (numpy or jax leaves) -> ``LittleNet`` on the
    CPU in eval mode; the width is read from the GRU recurrent matrix."""
    erb_bands = np.shape(tree["lin2"]["w"])[0]
    hidden = np.shape(tree["gru"]["w_hh"])[-1]
    net = LittleNet(erb_bands=erb_bands, width=hidden // erb_bands)
    state = {
        name: torch.from_numpy(np.array(tree[a][b], dtype=np.float32))
        for (a, b), name in _LEAVES.items()
    }
    net.load_state_dict(state)
    return net.eval()


def load_npz(path: str) -> LittleNet:
    """Path-keyed ``.npz`` checkpoint -> ``LittleNet`` (numpy only)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    with np.load(path) as data:
        tree: dict = {}
        for a, b in _LEAVES:
            key = f"['params']['{a}']['{b}']"
            if key not in data:
                raise KeyError(f"checkpoint {path} is missing leaf {key}")
            tree.setdefault(a, {})[b] = data[key]
    return params_from_jax(tree)
