"""The port's copies of ``benchmarks/scenes.py``'s ``speech_like`` and
``loudspeaker`` (numpy only, so one seed gives the same samples as there):
the package imports nothing of ``benchmarks``."""

from __future__ import annotations

import numpy as np

SR = 16000


def speech_like(rng, n, *, f0=120.0, gain=1.0):
    """Speech-like test signal: drifting-pitch harmonic stack * syllabic
    envelope with silent gaps + a small noise floor. Deterministic given rng.
    Peak-normalized to ``gain``."""
    t = np.arange(n) / SR
    f0_t = f0 * (1.0 + 0.08 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6.28)))
    phase = 2 * np.pi * np.cumsum(f0_t) / SR
    sig = np.zeros(n)
    for k, a in ((1, 1.0), (2, 0.6), (3, 0.45), (4, 0.3), (5, 0.2), (6, 0.12)):
        sig += a * np.sin(k * phase + rng.uniform(0, 6.28))
    # syllabic (~3-4 Hz) amplitude modulation with real pauses
    env = np.sin(2 * np.pi * 3.3 * t + rng.uniform(0, 6.28)) + 0.25
    env = np.clip(env, 0.0, None) ** 1.5
    sig = sig * env + 0.02 * rng.standard_normal(n)
    sig = sig / (np.abs(sig).max() + 1e-9)
    return (gain * sig).astype(np.float32)


def loudspeaker(x, drive=2.5):
    """Memoryless loudspeaker saturation: tanh soft clip (odd harmonics)."""
    return (np.tanh(drive * x) / drive).astype(np.float32)
