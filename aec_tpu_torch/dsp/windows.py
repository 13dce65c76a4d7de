"""Analysis windows (counterpart of ``aec_tpu/dsp/windows.py``).

The reference obtains its window via ``scipy.signal.get_window(win_type,
win_len, fftbins=True)``, i.e. the *periodic* variant. Built on the host in
float64 and cast at the use sites, byte-equal to the JAX package's builder.
"""

from __future__ import annotations

import numpy as np


def periodic_window(win_type: str | None, win_len: int) -> np.ndarray:
    """Periodic (DFT-even) window of length ``win_len`` as float64.

    ``None``/``"None"``/``"rect"`` give the all-ones window.
    """
    if win_type is None or win_type in ("None", "rect", "boxcar", "ones"):
        return np.ones(win_len, dtype=np.float64)
    n = np.arange(win_len, dtype=np.float64)
    phase = 2.0 * np.pi * n / win_len
    if win_type == "hann":
        return 0.5 - 0.5 * np.cos(phase)
    if win_type == "hamming":
        return 0.54 - 0.46 * np.cos(phase)
    if win_type == "blackman":
        return 0.42 - 0.5 * np.cos(phase) + 0.08 * np.cos(2.0 * phase)
    raise ValueError(f"unsupported window type: {win_type!r}")
