"""Model registry (``aec_tpu/models/registry.py``): every family of the JAX
registry.

Each entry: init, apply and loss callables and a note on its reference
lineage. A family of the JAX registry the port lacked would be listed in
``NOT_PORTED`` with the ROADMAP item that brings it; none is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    init: Callable[..., Any]
    apply: Callable[..., Any]
    loss: Callable[..., Any] | None
    stateful: bool  # True if init returns (params, state) (BatchNorm models)
    reference: str


# families of the JAX registry the port does not have yet, and the item that brings them
NOT_PORTED: dict[str, str] = {}


def _specs() -> dict[str, ModelSpec]:
    from aec_tpu_torch.models import (
        att_ccrn,
        dccrn,
        dct_net,
        fullsubnet,
        little_net,
        two_layer_gru,
    )

    return {
        "little_net": ModelSpec(
            "little_net", little_net.little_net_init, little_net.little_net_apply,
            little_net.little_net_loss, stateful=False,
            reference="ERB.py:203-335 (production model)",
        ),
        "two_layer_gru": ModelSpec(
            "two_layer_gru", two_layer_gru.two_layer_gru_init,
            two_layer_gru.two_layer_gru_apply, two_layer_gru.two_layer_gru_loss,
            stateful=False, reference="ERB.py:74-200",
        ),
        "dccrn": ModelSpec(
            "dccrn", dccrn.dccrn_init, dccrn.dccrn_apply, dccrn.dccrn_loss_v1, stateful=True,
            reference="dccrn.py:453-594 / dccrn2.py (use_clstm, masking modes)",
        ),
        "fullsubnet": ModelSpec(
            "fullsubnet", fullsubnet.fullsubnet_init, fullsubnet.fullsubnet_apply,
            fullsubnet.fullsubnet_loss, stateful=False,
            reference="models.py (driver only; module missing upstream — working realization)",
        ),
        "att_ccrn": ModelSpec(
            "att_ccrn", att_ccrn.att_ccrn_init, att_ccrn.att_ccrn_apply,
            att_ccrn.att_ccrn_loss, stateful=True,
            reference="attention_ccrn.py:240-422 (repaired; reference forward is broken)",
        ),
        "dct_dnn": ModelSpec(
            "dct_dnn", dct_net.dnn_init, dct_net.dnn_apply, dct_net.dnn_loss, stateful=False,
            reference="networks.py:254-348",
        ),
        "dct_cnn": ModelSpec(
            "dct_cnn", dct_net.cnn_init, dct_net.cnn_apply, dct_net.cnn_loss, stateful=False,
            reference="networks.py:350-474 (working realization of commented intent)",
        ),
    }


def get_model(name: str) -> ModelSpec:
    if name in NOT_PORTED:
        raise KeyError(f"model {name!r} is not ported yet (ROADMAP {NOT_PORTED[name]})")
    specs = _specs()
    if name not in specs:
        raise KeyError(f"unknown model {name!r}; available: {sorted(specs)}")
    return specs[name]


def list_models() -> list[str]:
    return sorted(_specs())
