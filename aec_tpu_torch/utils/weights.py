"""Weights carried over from and back to the JAX package.

The JAX LittleNet parameter tree (``aec_tpu/models/little_net.py``) already
uses torch's layouts: the GRU stacks its gates [r; z; n] with separate
input/hidden biases as ``torch.nn.GRU`` does, and the linear weights are
(out, in). So the mapping is a copy, leaf by leaf, both ways. TwoLayerGRU's
tree is the same with a 2E-wide GRU. DCCRN's and ATT-CCRN's (params, state)
trees and the param trees of FullSubNet and the DCT nets carry over as they
are: the modules (:class:`~aec_tpu_torch.models.tree_net.TreeNet` s) hold the
JAX trees, HWIO conv kernels included. :func:`param_tree` lays any ported
net's parameters out as its JAX family's tree, so the trainers write and read
one checkpoint format for every family (:func:`to_jax`, :func:`load_jax`).

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
from torch import nn

from aec_tpu_torch.models.att_ccrn import AttCcrn, AttCcrnConfig
from aec_tpu_torch.models.dccrn import Dccrn, DccrnConfig
from aec_tpu_torch.models.dct_net import DctCnn, DctCnnConfig, DctDnn, DctDnnConfig
from aec_tpu_torch.models.fullsubnet import FullSubNet, FullSubNetConfig
from aec_tpu_torch.models.little_net import LittleNet
from aec_tpu_torch.models.tree_net import TreeNet, copy_into, map_tree, model_state
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


def params_from_jax(tree, *, device="cuda") -> LittleNet:
    """JAX LittleNet param tree (numpy or jax leaves) -> ``LittleNet`` on
    ``device`` (the card unless the caller asks for ``device="cpu"``) in
    eval mode; the width is read from the GRU recurrent matrix."""
    erb_bands = np.shape(tree["lin2"]["w"])[0]
    hidden = np.shape(tree["gru"]["w_hh"])[-1]
    net = LittleNet(erb_bands=erb_bands, width=hidden // erb_bands)
    load_jax(net, tree)
    return net.to(device).eval()


def params_to_jax(net: LittleNet) -> dict:
    """``LittleNet`` -> the JAX param tree of numpy arrays (the inverse of
    :func:`params_from_jax`)."""
    return param_tree(net, _np)


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
    load_jax(net, tree)
    return net.to(device).eval()


def two_layer_gru_to_jax(net: TwoLayerGru) -> dict:
    """``TwoLayerGru`` -> the JAX param tree of numpy arrays."""
    return param_tree(net, _np)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _to_torch(tree):
    return map_tree(tree, lambda v: torch.from_numpy(np.array(v, dtype=np.float32)))


def _to_numpy(tree):
    return map_tree(tree, _np)


def param_tree(net: nn.Module, fn=lambda p: p):
    """``net``'s parameters laid out as its JAX family's param tree, each
    leaf ``fn(parameter)``: LittleNet's and TwoLayerGru's through their leaf
    maps, a :class:`TreeNet`'s as it holds them."""
    if isinstance(net, TreeNet):
        return map_tree(net.params(), fn)
    leaves = {LittleNet: _LEAVES, TwoLayerGru: _TWO_LAYER_GRU}[type(net)]
    named = dict(net.named_parameters())
    tree: dict = {}
    for (a, b), name in leaves.items():
        tree.setdefault(a, {})[b] = fn(named[name])
    return tree


def leaf_pairs(tree, other):
    """The leaves of ``tree`` beside those at the same paths of ``other``
    (dict keys and list indices; ``other`` may hold more)."""
    if isinstance(tree, dict):
        return [pair for k in tree for pair in leaf_pairs(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in leaf_pairs(v, other[i])]
    return [(tree, other)]


def to_jax(net: nn.Module) -> tuple[dict, dict]:
    """Any ported net -> its JAX family's (params, model_state) trees of
    numpy arrays; the state is ``{}`` for a stateless family."""
    return param_tree(net, _np), _to_numpy(model_state(net))


def load_jax(net: nn.Module, params, state=None) -> None:
    """Copy JAX (params, model_state) trees (numpy or jax leaves) into
    ``net``'s parameters and buffers in place, on their device."""
    with torch.no_grad():
        for p, v in leaf_pairs(param_tree(net), params):
            if tuple(np.shape(v)) != tuple(p.shape):
                raise ValueError(f"a leaf of shape {np.shape(v)} for a parameter of shape "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(v, dtype=np.float32)))
        if state:
            copy_into(model_state(net), _to_torch(state))


def dccrn_from_jax(params, state, cfg: DccrnConfig = DccrnConfig(), *, device="cuda") -> Dccrn:
    """JAX DCCRN (params, state) trees (numpy or jax leaves) -> ``Dccrn`` on
    ``device``, eval mode."""
    return Dccrn(_to_torch(params), _to_torch(state), cfg).to(device).eval()


def dccrn_to_jax(net: Dccrn) -> tuple[dict, dict]:
    """``Dccrn`` -> the JAX (params, state) trees of numpy arrays."""
    return _to_numpy(net.params()), _to_numpy(net.state())


def att_ccrn_from_jax(params, state, cfg: AttCcrnConfig = AttCcrnConfig(), *,
                      device="cuda") -> AttCcrn:
    """JAX ATT-CCRN (params, state) trees -> ``AttCcrn`` on ``device``, eval
    mode."""
    return AttCcrn(_to_torch(params), _to_torch(state), cfg).to(device).eval()


def att_ccrn_to_jax(net: AttCcrn) -> tuple[dict, dict]:
    """``AttCcrn`` -> the JAX (params, state) trees of numpy arrays."""
    return _to_numpy(net.params()), _to_numpy(net.state())


def fullsubnet_from_jax(params, cfg: FullSubNetConfig = FullSubNetConfig(), *,
                        device="cuda") -> FullSubNet:
    """JAX FullSubNet param tree -> ``FullSubNet`` on ``device``, eval mode."""
    return FullSubNet(_to_torch(params), cfg).to(device).eval()


def fullsubnet_to_jax(net: FullSubNet) -> dict:
    """``FullSubNet`` -> the JAX param tree of numpy arrays."""
    return _to_numpy(net.params())


def dct_dnn_from_jax(params, cfg: DctDnnConfig = DctDnnConfig(), *, device="cuda") -> DctDnn:
    """JAX DCT-DNN param tree -> ``DctDnn`` on ``device``, eval mode."""
    return DctDnn(_to_torch(params), cfg).to(device).eval()


def dct_dnn_to_jax(net: DctDnn) -> dict:
    """``DctDnn`` -> the JAX param tree of numpy arrays."""
    return _to_numpy(net.params())


def dct_cnn_from_jax(params, cfg: DctCnnConfig = DctCnnConfig(), *, device="cuda") -> DctCnn:
    """JAX DCT-CNN param tree -> ``DctCnn`` on ``device``, eval mode."""
    return DctCnn(_to_torch(params), cfg).to(device).eval()


def dct_cnn_to_jax(net: DctCnn) -> dict:
    """``DctCnn`` -> the JAX param tree of numpy arrays."""
    return _to_numpy(net.params())
