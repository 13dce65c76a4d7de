"""Stage-1 linear echo cancellers (``aec_tpu/linear``)."""

from aec_tpu_torch.linear import kalman, nlms
from aec_tpu_torch.linear.kalman import kalman_cancel, kalman_filter, kalman_init, kalman_step
from aec_tpu_torch.linear.nlms import nlms_cancel, nlms_filter, nlms_init, nlms_step

__all__ = [
    "nlms",
    "kalman",
    "nlms_init",
    "nlms_step",
    "nlms_filter",
    "nlms_cancel",
    "kalman_init",
    "kalman_step",
    "kalman_filter",
    "kalman_cancel",
]
