"""K1, the batched Kalman stage 1 (``csrc/kalman_batched.cu``): operations and
bytes of its FFT step, as ``chip_smoke.py``'s ``stage1_bounds`` counts them."""

from __future__ import annotations

from aec_bench.counts.fft import SPLIT_FLOPS, complex_fft_flops

# the filter algebra: per partition bin predict 9, echo estimate 8,
# denominator 5, gain 8, covariance 8, constraint update 2; per bin the psd
# and E / den
ALGEBRA_LK, ALGEBRA_K = 40, 10


def step_flops(block: int, partitions: int) -> int:
    """One block step of one utterance: 2 + L forward real FFTs of 2B points
    (far frame, residual, L constraint tails), 1 + L inverse ones (echo, L
    constraint heads), the filter algebra and the echo subtraction."""
    cfft, k = complex_fft_flops(block), block + 1
    fwd = (2 + partitions) * (cfft + SPLIT_FLOPS * k)
    inv = (1 + partitions) * (cfft + SPLIT_FLOPS * block)
    return fwd + inv + ALGEBRA_LK * partitions * k + ALGEBRA_K * k + block


def count(cfg: dict, utterances: int, samples: int) -> tuple[float, float]:
    """(flops, bytes) of stage 1 over ``utterances`` of ``samples``: far
    and mic read once, the residual written once."""
    block, parts = cfg["stft"]["hop"], cfg["kalman"]["n_blocks"]
    steps = samples // block
    return (float(utterances * steps * step_flops(block, parts)),
            float(3 * 4 * utterances * samples))
