"""Weights carried over from and back to the JAX package.

The JAX LittleNet parameter tree (``aec_tpu/models/little_net.py``) already
uses torch's layouts: the GRU stacks its gates [r; z; n] with separate
input/hidden biases as ``torch.nn.GRU`` does, and the linear weights are
(out, in). So the mapping is a copy, leaf by leaf, both ways. TwoLayerGRU's
tree is the same with a 2E-wide GRU. DCCRN's (params, state) trees carry
over as they are: :class:`~aec_tpu_torch.models.dccrn.Dccrn` holds the JAX
trees, HWIO conv kernels included.

Checkpoints (``checkpoints/little_net_*.npz``) store leaves keyed by their
tree path, e.g. ``['params']['gru']['w_ih']`` (``aec_tpu/train/
checkpoints.py``); :func:`load_npz` reads them with numpy alone and, like
the JAX restore, ignores extra entries such as optimizer state.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from aec_tpu_torch.models.dccrn import Dccrn, DccrnConfig
from aec_tpu_torch.models.little_net import LittleNet
from aec_tpu_torch.models.two_layer_gru import TwoLayerGru

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


def tree_from_named(values: Mapping[str, Any]) -> dict:
    """Per-parameter values keyed by ``LittleNet``'s parameter names ->
    the JAX tree layout ``{"gru": {...}, "lin1": {...}, "lin2": {...}}``."""
    tree: dict = {}
    for (a, b), name in _LEAVES.items():
        tree.setdefault(a, {})[b] = values[name]
    return tree


def named_from_tree(tree) -> dict[str, Any]:
    """The inverse of :func:`tree_from_named`."""
    return {name: tree[a][b] for (a, b), name in _LEAVES.items()}


def params_from_jax(tree, *, device="cuda") -> LittleNet:
    """JAX LittleNet param tree (numpy or jax leaves) -> ``LittleNet`` on
    ``device`` (the card unless the caller asks for ``device="cpu"``) in
    eval mode; the width is read from the GRU recurrent matrix."""
    erb_bands = np.shape(tree["lin2"]["w"])[0]
    hidden = np.shape(tree["gru"]["w_hh"])[-1]
    net = LittleNet(erb_bands=erb_bands, width=hidden // erb_bands)
    load_params(net, tree)
    return net.to(device).eval()


def params_to_jax(net: LittleNet) -> dict:
    """``LittleNet`` -> the JAX param tree of numpy arrays (the inverse of
    :func:`params_from_jax`)."""
    return tree_from_named(
        {name: p.detach().cpu().numpy() for name, p in net.named_parameters()}
    )


def load_params(net: LittleNet, tree) -> None:
    """Copy a JAX param tree into ``net``'s parameters, on their device."""
    net.load_state_dict({
        name: torch.from_numpy(np.array(v, dtype=np.float32))
        for name, v in named_from_tree(tree).items()
    })


def load_npz(path: str, *, device="cuda") -> LittleNet:
    """Path-keyed ``.npz`` checkpoint -> ``LittleNet`` on ``device`` (numpy
    only)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    with np.load(path) as data:
        tree: dict = {}
        for a, b in _LEAVES:
            key = f"['params']['{a}']['{b}']"
            if key not in data:
                raise KeyError(f"checkpoint {path} is missing leaf {key}")
            tree.setdefault(a, {})[b] = data[key]
    return params_from_jax(tree, device=device)


_TWO_LAYER_GRU = {key: name.replace("gru1.", "gru.") for key, name in _LEAVES.items()}


def two_layer_gru_from_jax(tree, *, device="cuda") -> TwoLayerGru:
    """JAX TwoLayerGRU param tree -> ``TwoLayerGru`` on ``device``, eval mode."""
    net = TwoLayerGru(erb_bands=np.shape(tree["lin2"]["w"])[0])
    net.load_state_dict({name: torch.from_numpy(np.array(tree[a][b], dtype=np.float32))
                         for (a, b), name in _TWO_LAYER_GRU.items()})
    return net.to(device).eval()


def two_layer_gru_to_jax(net: TwoLayerGru) -> dict:
    """``TwoLayerGru`` -> the JAX param tree of numpy arrays."""
    values = {name: p.detach().cpu().numpy() for name, p in net.named_parameters()}
    tree: dict = {}
    for (a, b), name in _TWO_LAYER_GRU.items():
        tree.setdefault(a, {})[b] = values[name]
    return tree


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def dccrn_from_jax(params, state, cfg: DccrnConfig = DccrnConfig(), *, device="cuda") -> Dccrn:
    """JAX DCCRN (params, state) trees (numpy or jax leaves) -> ``Dccrn`` on
    ``device``, eval mode."""
    to_t = lambda v: torch.from_numpy(np.array(v, dtype=np.float32))  # noqa: E731
    return Dccrn(_map_tree(params, to_t), _map_tree(state, to_t), cfg).to(device).eval()


def dccrn_to_jax(net: Dccrn) -> tuple[dict, dict]:
    """``Dccrn`` -> the JAX (params, state) trees of numpy arrays."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return _map_tree(net.params(), to_np), _map_tree(net.state(), to_np)
