"""Stage-2 neural post-filters (``aec_tpu/models``)."""

from aec_tpu_torch.models import (
    att_ccrn,
    dccrn,
    dct_net,
    fullsubnet,
    little_net,
    registry,
    two_layer_gru,
)
from aec_tpu_torch.models.little_net import (
    LittleNetParams,
    little_net_apply,
    little_net_init,
    little_net_loss,
)
from aec_tpu_torch.models.registry import get_model, list_models

__all__ = [
    "att_ccrn",
    "dccrn",
    "dct_net",
    "fullsubnet",
    "little_net",
    "registry",
    "two_layer_gru",
    "LittleNetParams",
    "little_net_init",
    "little_net_apply",
    "little_net_loss",
    "get_model",
    "list_models",
]
