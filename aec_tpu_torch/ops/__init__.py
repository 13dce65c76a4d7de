"""Recurrent building blocks (``aec_tpu/ops``)."""
