"""Pipelines: the two-stage composition (``aec_tpu/pipeline``)."""
