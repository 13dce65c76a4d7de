"""Short-Time Objective Intelligibility (STOI, Taal et al. 2011): a copy of
``aec_tpu/train/stoi.py`` (numpy + scipy), so the port imports nothing of
the JAX package. A host-side implementation of the published algorithm:

- resample to 10 kHz;
- drop silent frames (energy > 40 dB below the loudest frame, 256/128 hann);
- 512-pt STFT; 15 one-third-octave bands from 150 Hz;
- per 384 ms (30-frame) segment: normalize + clip at -15 dB SDR, correlate
  clean vs degraded band envelopes; average everything.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.signal import resample_poly

FS = 10000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30  # frames per analysis segment (384 ms)
BETA = -15.0  # clipping SDR in dB
DYN_RANGE = 40.0


@functools.lru_cache(maxsize=1)
def _third_octave_bands() -> np.ndarray:
    """(NUM_BANDS, NFFT//2+1) 0/1 matrix grouping STFT bins into bands."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    cf = MIN_FREQ * 2.0 ** (np.arange(NUM_BANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        lo_i = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_i:hi_i] = 1.0
    return obm


def _frames(x: np.ndarray) -> np.ndarray:
    hop = N_FRAME // 2
    n = (len(x) - N_FRAME) // hop + 1
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(n)[:, None] * hop + np.arange(N_FRAME)[None, :]
    return x[idx] * np.hanning(N_FRAME + 2)[1:-1]


def _remove_silent(clean: np.ndarray, deg: np.ndarray):
    """Drop sub-(max-40 dB) frames the published way (Taal 2011 MATLAB
    removeSilentFrames): keep the energetic frames of BOTH signals, overlap-
    add them back into continuous time signals, and return those. The OLA
    reconstruction (rather than masking the frame list) matters when silent
    frames are interior — the re-framed STFT then spans the splice."""
    hop = N_FRAME // 2
    fc, fd = _frames(clean), _frames(deg)
    energy = 20.0 * np.log10(np.linalg.norm(fc, axis=1) + 1e-12)
    mask = energy > energy.max() - DYN_RANGE
    fc, fd = fc[mask], fd[mask]
    n_kept = fc.shape[0]
    if n_kept == 0:
        return np.zeros(0), np.zeros(0)
    out_len = (n_kept - 1) * hop + N_FRAME
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    # frames come out of _frames already hann-windowed; the published
    # algorithm overlap-adds exactly these windowed frames.
    for i in range(n_kept):
        xs[i * hop : i * hop + N_FRAME] += fc[i]
        ys[i * hop : i * hop + N_FRAME] += fd[i]
    return xs, ys


def _band_envelopes(frames: np.ndarray) -> np.ndarray:
    spec = np.fft.rfft(frames, n=NFFT, axis=1)
    power = np.abs(spec) ** 2
    return np.sqrt(power @ _third_octave_bands().T)  # (n_frames, bands)


def stoi(clean: np.ndarray, degraded: np.ndarray, sr: int = 16000) -> float:
    """STOI in [~0, 1]; higher is more intelligible."""
    clean = np.asarray(clean, dtype=np.float64)
    degraded = np.asarray(degraded, dtype=np.float64)
    n = min(len(clean), len(degraded))
    clean, degraded = clean[:n], degraded[:n]
    if sr != FS:
        g = np.gcd(int(FS), int(sr))
        clean = resample_poly(clean, FS // g, sr // g)
        degraded = resample_poly(degraded, FS // g, sr // g)
    xs, ys = _remove_silent(clean, degraded)
    fc, fd = _frames(xs), _frames(ys)  # STFT windows the spliced signals again
    if fc.shape[0] < N_SEG:
        return float("nan")
    xb = _band_envelopes(fc)  # (T, J)
    yb = _band_envelopes(fd)

    corrs = []
    clip = 10.0 ** (-BETA / 20.0)
    for m in range(N_SEG, xb.shape[0] + 1):
        x = xb[m - N_SEG : m]  # (N, J)
        y = yb[m - N_SEG : m]
        alpha = np.linalg.norm(x, axis=0) / (np.linalg.norm(y, axis=0) + 1e-12)
        y_scaled = y * alpha[None, :]
        y_clipped = np.minimum(y_scaled, x * (1.0 + clip))
        xz = x - x.mean(axis=0)
        yz = y_clipped - y_clipped.mean(axis=0)
        denom = np.linalg.norm(xz, axis=0) * np.linalg.norm(yz, axis=0) + 1e-12
        corrs.append(np.sum(xz * yz, axis=0) / denom)
    return float(np.mean(corrs))
