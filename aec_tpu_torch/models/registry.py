"""Model registry (``aec_tpu/models/registry.py``) for the families ported so far.

Each entry: init, apply and loss callables and a note on its reference
lineage. The JAX package's other families raise ``KeyError`` naming the
ROADMAP item that brings them.
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
NOT_PORTED = {"dct_dnn": "A2", "dct_cnn": "A2"}


def _specs() -> dict[str, ModelSpec]:
    from aec_tpu_torch.models import att_ccrn, dccrn, fullsubnet, little_net, two_layer_gru

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
            reference="models.py (training script only; module missing upstream — working "
                      "realization)",
        ),
        "att_ccrn": ModelSpec(
            "att_ccrn", att_ccrn.att_ccrn_init, att_ccrn.att_ccrn_apply,
            att_ccrn.att_ccrn_loss, stateful=True,
            reference="attention_ccrn.py:240-422 (repaired; reference forward is broken)",
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
