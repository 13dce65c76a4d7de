"""Configuration dataclasses of the port (``aec_tpu/configs.py``).

Restated with the same fields and defaults, so the port imports nothing of
the JAX package; ``tests/test_torch_kalman.py`` and
``tests/test_torch_nlms.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NlmsConfig:
    """Stage-1 frequency-domain (multidelay) NLMS. The update's denominator
    is ``power + eps + eps_rel * mean_k(power) + beta * psi``: ``eps_rel``
    regularizes near-silent bins of harmonic far ends, ``beta`` is
    error-power step control under double talk (see the JAX package's
    config for the measured trade); ``eps_rel=0, beta=0`` is the classic
    update."""

    n_blocks: int = 10  # far-end history partitions (filter taps per bin)
    mu: float = 0.5  # step size
    eps: float = 1e-6  # absolute regularizer in the normalized update
    power_smooth: float = 0.9  # smoothing of the per-bin far-end power
    eps_rel: float = 0.1  # regularization relative to broadband far power
    beta: float = 1.0  # error-power (double-talk) step control
    err_smooth: float = 0.5  # smoothing of the residual psd estimate psi


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
