"""Training: loop, checkpoints, metrics (``aec_tpu/train``)."""
