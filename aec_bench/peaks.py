"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet; dense rates, no sparsity). A roofline share or an ``mfu`` is stated
against these, with the card's power limit printed beside it."""

PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_HBM = 3.35e12  # bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    over the fp32 peak and the bytes over the HBM rate."""
    return max(flops / PEAK_FP32, nbytes / PEAK_HBM)
