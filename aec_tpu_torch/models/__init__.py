"""Stage-2 neural post-filters (``aec_tpu/models``)."""
