"""Pipelines: the two-stage composition, the streaming runtime, data I/O
and loading (``aec_tpu/pipeline``)."""
