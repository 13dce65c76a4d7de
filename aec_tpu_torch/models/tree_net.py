"""An ``nn.Module`` holding a model family's JAX-layout trees (DCCRN, ATT-CCRN, FullSubNet).

The functional models take nested dicts / lists of tensors in the JAX
package's layout, so a JAX tree carries over leaf for leaf. :class:`TreeNet`
holds the same trees as a module: the parameters as ``nn.Parameter`` s
(``self.net``), the BatchNorm running statistics as buffers
(``self.stats``; empty for a stateless family). A stateful family's
``forward`` calls its ``apply(params, state, mic, far, cfg, train=...)`` and,
in train mode, writes the new statistics back into the buffers.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn


def _module_of(tree, leaf) -> nn.Module:
    """A module tree mirroring ``tree`` (dicts -> modules, lists ->
    ModuleLists); ``leaf(module, name, tensor)`` registers each leaf."""
    if isinstance(tree, list):
        return nn.ModuleList([_module_of(v, leaf) for v in tree])
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            m.add_module(k, _module_of(v, leaf))
        else:
            leaf(m, k, v)
    return m


def _tree_of(m: nn.Module, which: str):
    """The inverse of :func:`_module_of`: the tensors as a nested dict/list."""
    if isinstance(m, nn.ModuleList):
        return [_tree_of(c, which) for c in m]
    own = m._parameters if which == "params" else m._buffers
    tree = dict(own.items())
    tree.update({k: _tree_of(c, which) for k, c in m.named_children()})
    return tree


def copy_into(dst, src) -> None:
    """Copy the leaves of tree ``src`` into the tensors of tree ``dst``."""
    if isinstance(dst, dict):
        for k in dst:
            copy_into(dst[k], src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            copy_into(d, s)
    else:
        dst.copy_(src)


class TreeNet(nn.Module):
    """(params, state) trees as a module; subclasses name their ``apply``."""

    apply_fn: Callable[..., tuple[dict, Any]]

    def __init__(self, params: dict, state: dict, cfg):
        super().__init__()
        self.cfg = cfg
        self.net = _module_of(params, lambda m, k, v: m.register_parameter(
            k, nn.Parameter(torch.as_tensor(v, dtype=torch.float32))))
        self.stats = _module_of(state, lambda m, k, v: m.register_buffer(
            k, torch.as_tensor(v, dtype=torch.float32)))

    def params(self) -> dict:
        return _tree_of(self.net, "params")

    def state(self) -> dict:
        return _tree_of(self.stats, "buffers")

    def forward(self, mic: torch.Tensor, far: torch.Tensor) -> dict:
        out, new_state = type(self).apply_fn(self.params(), self.state(), mic, far, self.cfg,
                                             train=self.training)
        if self.training:
            with torch.no_grad():
                copy_into(self.state(), new_state)
        return out
