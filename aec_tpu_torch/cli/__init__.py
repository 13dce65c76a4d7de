"""Command-line entry points (``aec_tpu/cli``)."""
