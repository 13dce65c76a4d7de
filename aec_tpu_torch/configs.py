"""Configuration dataclasses of the port (``aec_tpu/configs.py``).

Restated with the same fields and defaults, so the port imports nothing of
the JAX package; ``tests/test_torch_kalman.py``, ``tests/test_torch_nlms.py``,
``tests/test_torch_train.py`` and ``tests/test_torch_public_names.py`` hold
the two equal.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpeechConfig:
    """Front-end / signal configuration (the reference's speech_conf)."""

    in_norm: bool = True
    sample_rate: int = 16000
    win_size: int = 512
    hop_size: int = 256
    win_type: str = "hann"

    @property
    def n_freqs(self) -> int:
        return self.win_size // 2 + 1


@dataclasses.dataclass(frozen=True)
class ErbConfig:
    """ERB filterbank configuration (the reference's erb_conf)."""

    n_freqs: int = 257
    sample_rate: int = 16000
    total_erb_bands: int = 32
    low_freq: float = 0.0
    max_freq: float = 8000.0


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop configuration (the reference's train_conf). The
    reference never calls ``optimizer.zero_grad()``; the port, like the JAX
    package, resets gradients every step (a documented divergence)."""

    lr: float = 1e-5
    lr_decay_factor: float = 0.5
    lr_decay_period: int = 5  # epochs between stepwise lr decays
    clip_norm: float = -1.0  # < 0 disables clipping (reference semantics)
    max_n_epochs: int = 50
    batch_size: int = 16
    logging_period: int = 0  # 0 -> once per epoch
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LittleNetConfig:
    """Production model hyperparameters (the reference's Little_net)."""

    erb_bands: int = 32
    gru_hidden: int = 32  # == erb_bands


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Data pipeline configuration."""

    sample_rate: int = 16000
    bucket_quantum: int = 4096  # pad lengths up to a multiple (static shapes)


DEFAULT_SPEECH = SpeechConfig()
DEFAULT_ERB = ErbConfig()
DEFAULT_TRAIN = TrainConfig()
DEFAULT_NLMS = NlmsConfig()
DEFAULT_KALMAN = KalmanConfig()
