"""Equivalent Rectangular Bandwidth (ERB) filterbank (``aec_tpu/dsp/erb.py``).

A host-side float64 numpy builder of the reference's Hohmann-2002-style
analysis matrix (raised-cosine bands, 50% overlapped, between ERB-uniform
cutoffs). Byte-equal to the JAX package's builder; ``perfect=True`` adds the
low-/high-pass reconstruction bands the reference computes and discards.
"""

from __future__ import annotations

import functools

import numpy as np

_EAR_Q = 9.265
_MIN_BW = 24.7


def freq_to_erb(freq_hz):
    """[Hohmann2002] Eq. 16."""
    return _EAR_Q * np.log(1.0 + np.asarray(freq_hz, dtype=np.float64) / (_MIN_BW * _EAR_Q))


def erb_to_freq(erb):
    """[Hohmann2002] Eq. 17."""
    return (np.exp(np.asarray(erb, dtype=np.float64) / _EAR_Q) - 1.0) * _MIN_BW * _EAR_Q


@functools.lru_cache(maxsize=16)
def _erb_filterbank_np(
    n_freqs: int,
    sample_rate: int,
    n_bands: int,
    low_freq: float,
    max_freq: float,
    perfect: bool,
) -> np.ndarray:
    freqs = np.linspace(0.0, max_freq, n_freqs)  # Hz per STFT bin
    erb_lims = np.linspace(freq_to_erb(low_freq), freq_to_erb(max_freq), n_bands + 2)
    cutoffs = erb_to_freq(erb_lims)

    cos_bands = np.zeros((n_freqs, n_bands))
    for i in range(n_bands):
        lo_hz, hi_hz = cutoffs[i], cutoffs[i + 2]
        lo = int(np.min(np.where(freqs > lo_hz)))  # strict >, as the reference
        hi = int(np.max(np.where(freqs < hi_hz)))  # strict <
        center = (freq_to_erb(lo_hz) + freq_to_erb(hi_hz)) / 2.0
        width = freq_to_erb(hi_hz) - freq_to_erb(lo_hz)
        cos_bands[lo : hi + 1, i] = np.cos(
            (freq_to_erb(freqs[lo : hi + 1]) - center) / width * np.pi
        )
    if not perfect:
        return cos_bands

    full = np.zeros((n_freqs, n_bands + 2))
    full[:, 1 : n_bands + 1] = cos_bands
    hi = int(np.max(np.where(freqs < cutoffs[1])))
    full[: hi + 1, 0] = np.sqrt(1.0 - full[: hi + 1, 1] ** 2)
    lo = int(np.min(np.where(freqs > cutoffs[n_bands])))
    full[lo:, n_bands + 1] = np.sqrt(1.0 - full[lo:, n_bands] ** 2)
    return full


def erb_filterbank(
    n_freqs: int = 257,
    sample_rate: int = 16000,
    n_bands: int = 32,
    low_freq: float = 0.0,
    max_freq: float = 8000.0,
    *,
    perfect: bool = False,
    dtype=np.float32,
) -> np.ndarray:
    """ERB projection matrix ``(n_freqs, n_bands)`` as a host numpy array.

    Use ``torch.as_tensor(erb_filterbank(), device=...)`` to place it; it is
    applied as ``mag @ erb`` (analysis) and ``erb_mag @ erb.T`` (the
    un-normalized back-projection).
    """
    fb = _erb_filterbank_np(
        int(n_freqs), int(sample_rate), int(n_bands), float(low_freq),
        float(max_freq), bool(perfect),
    )
    return fb.astype(dtype)
