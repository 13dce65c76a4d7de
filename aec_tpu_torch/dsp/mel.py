"""Mel filterbank (``aec_tpu/dsp/mel.py``; python_speech_features.get_filterbanks equivalent).

The reference's FullSubNet training script builds a 21-filter mel bank over
a 320-point FFT (models.py:117: nfilt=21, nfft=320, sr=16000, 20-8000 Hz):
triangular filters with mel-uniform peaks, as a (nfft//2+1, nfilt) matrix.
numpy only, built on the host in float64 and cast on the way out, as in the
JAX package.
"""

from __future__ import annotations

import functools

import numpy as np


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(nfilt: int, nfft: int, sample_rate: int, low_freq: float,
                       high_freq: float) -> np.ndarray:
    mel_pts = np.linspace(hz_to_mel(low_freq), hz_to_mel(high_freq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel_to_hz(mel_pts) / sample_rate).astype(int)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fb.T  # (nfft//2+1, nfilt), for `mag @ fb`


def mel_filterbank(nfilt: int = 21, nfft: int = 320, sample_rate: int = 16000,
                   low_freq: float = 20.0, high_freq: float = 8000.0,
                   dtype=np.float32) -> np.ndarray:
    return _mel_filterbank_np(int(nfilt), int(nfft), int(sample_rate), float(low_freq),
                              float(high_freq)).astype(dtype)
