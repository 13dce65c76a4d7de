"""Stage-1 linear echo cancellers (``aec_tpu/linear``)."""
