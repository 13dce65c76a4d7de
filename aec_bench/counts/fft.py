"""Flops of the real FFTs the stage-1 and stage-2 kernels run (``csrc/fft.cuh``'s
radix plan: passes of 8, then 4, 2, 5 and 3)."""

from __future__ import annotations

# flops of one radix-R butterfly; a pass after the first also multiplies
# R - 1 twiddles, 6 flops each
DFT_FLOPS = {2: 4, 3: 16, 4: 16, 5: 48, 8: 56}
SPLIT_FLOPS = 14  # the real-FFT split, per bin


def radix_plan(m: int) -> tuple[int, ...]:
    plan = []
    for r in (8, 4, 2, 5, 3):
        while m % r == 0 and m > 1:
            plan.append(r)
            m //= r
    if m != 1:
        raise ValueError("the count knows FFT plans of radices 2, 3 and 5 only")
    return tuple(plan)


def complex_fft_flops(m: int) -> int:
    """Flops of one complex FFT of ``m`` points."""
    total, done = 0, 1
    for r in radix_plan(m):
        total += m // r * (DFT_FLOPS[r] + (6 * (r - 1) if done > 1 else 0))
        done *= r
    return total
