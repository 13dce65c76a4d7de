"""WAV read/write + resampling (``aec_tpu/pipeline/audio_io.py``, numpy and scipy only).

The reference decodes with librosa and writes with soundfile
(generate_h5files/train_wav2h5.py:20-23, scripts/test.py:165-169); the
package needs neither and carries its own host-side codec: scipy-based
16/24/32-bit PCM and float WAV, with polyphase resampling
(``scipy.signal.resample_poly``). Like librosa, ``read_wav`` returns float32
in [-1, 1) and downmixes multichannel to mono by averaging.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str, sr: int | None = None) -> tuple[np.ndarray, int]:
    """Load a wav as mono float32; optionally resample to ``sr``.

    Returns (samples, sample_rate).
    """
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64 wavs
        x = data.astype(np.float32)
    if x.ndim == 2:  # downmix to mono (librosa.load default)
        x = x.mean(axis=1)
    if sr is not None and sr != file_sr:
        g = np.gcd(int(sr), int(file_sr))
        x = resample_poly(x, sr // g, file_sr // g).astype(np.float32)
        file_sr = sr
    return np.ascontiguousarray(x, dtype=np.float32), int(file_sr)


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float32 samples as a float32 WAV (soundfile-compatible)."""
    wavfile.write(path, sr, np.asarray(x, dtype=np.float32))
