"""Bulk-delay estimation (GCC-PHAT) and far-end pre-alignment (``aec_tpu/dsp/delay.py``).

The stage-1 cancellers track any echo path inside their partition span
(``KalmanConfig.n_blocks * block`` = 160 ms by default), but a bulk delay
beyond it is invisible to them. A generalized cross-correlation
pre-alignment finds it:

- :func:`gcc_phat_delay`: batched GCC-PHAT, the whitened cross-spectrum
  through ``torch.fft``, argmax over the allowed lag window;
- :func:`align_far`: shift each far-end row forward by its delay;
- :func:`estimate_and_align`: the two composed, returning the aligned far
  end and the shifts applied.

``cli/infer --align-far-ms N`` applies this before the stage-1 canceller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gcc_phat_delay(far: torch.Tensor, mic: torch.Tensor, *, max_delay: int,
                   min_delay: int = 0, eps: float = 1e-12) -> torch.Tensor:
    """Per-utterance bulk delay (samples, int32) of mic's echo behind far,
    [B, n] -> [B]. PHAT weighting keeps the correlation peak sharp for
    colored far ends through reverberant paths. Only lags in
    [min_delay, max_delay) are searched (the echo cannot precede the
    reference); both signals are zero-padded by ``max_delay`` so the
    correlation is linear, not circular."""
    n = far.shape[-1] + max_delay
    x = torch.fft.rfft(far.to(torch.float32), n=n)
    y = torch.fft.rfft(mic.to(torch.float32), n=n)
    cross = y * torch.conj(x)
    r = torch.fft.irfft(cross / (torch.abs(cross) + eps), n=n)  # [B, n] lags
    window = r[..., min_delay:max_delay]
    return (min_delay + torch.argmax(window, dim=-1)).to(torch.int32)


def align_far(far: torch.Tensor, delay: torch.Tensor, max_delay: int) -> torch.Tensor:
    """Shift each far row FORWARD by its delay (zeros enter at the front):
    ``aligned[t] = far[t - delay]``; ``max_delay`` bounds the shift."""
    n = far.shape[-1]
    padded = F.pad(far, (max_delay, 0))
    start = (max_delay - delay.to(torch.int64)).clamp(0, max_delay)
    idx = start[:, None] + torch.arange(n, device=far.device)[None]
    return torch.gather(padded, -1, idx)


def estimate_and_align(far: torch.Tensor, mic: torch.Tensor, *, max_delay: int,
                       min_delay: int = 0, guard: int = 512,
                       block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """(aligned_far, applied_shifts), batched [B, n].

    The raw peak is backed off by ``guard`` samples (the peak marks the
    dominant path, not the first, and aligning to it exactly makes earlier
    taps acausal) and floored to a multiple of ``block`` (a sub-block
    silent prefix can stall the Kalman filter's cold start; the JAX
    package's docstring has the measurements)."""
    d = gcc_phat_delay(far, mic, max_delay=max_delay, min_delay=min_delay)
    shift = torch.clamp(d - guard, min=0) // block * block
    return align_far(far, shift, max_delay), shift
