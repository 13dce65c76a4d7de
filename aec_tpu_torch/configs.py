"""Configuration dataclasses of the port (``aec_tpu/configs.py``).

Restated with the same fields and defaults, so the port imports nothing of
the JAX package; ``tests/test_torch_kalman.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KalmanConfig:
    """Stage-1 partitioned-block frequency-domain Kalman filter: diagonal
    state covariance per (partition, bin); transition factor ``a`` models
    echo-path drift; ``q_min`` is an absolute process-noise floor (off by
    default, see the JAX package's config for the measured trade)."""

    n_blocks: int = 10
    a: float = 0.999
    psi_floor: float = 1e-10  # floor for covariance / psd estimates
    obs_smooth: float = 0.5  # smoothing of the observation-noise psd
    q_min: float = 0.0
    init_p: float = 10.0  # initial state covariance
