"""Recurrent building blocks (``aec_tpu/ops``)."""

from aec_tpu_torch.ops import gru
from aec_tpu_torch.ops.gru import GruParams, gru_cell, gru_init, gru_scan

__all__ = ["gru", "GruParams", "gru_init", "gru_cell", "gru_scan"]
