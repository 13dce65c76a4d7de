"""The convolutions' device ms a step: cuDNN's kernels (and the library's
implicit-GEMM convolutions) that the complex convs and their gradients run."""

from aec_bench.trace import seconds_of

PATTERNS = ("conv", "fprop", "dgrad", "wgrad", "cudnn")


def read(r):
    s, n = seconds_of(r["trace"], *PATTERNS)
    w = r["work"]
    if n == 0 or "steps" not in w:
        return None
    return 1e3 * s / w["steps"]
