"""K1 as a batch of one: its device ms an utterance."""

from aec_bench.trace import seconds_of


def read(r):
    s, n = seconds_of(r["trace"], "kalman_batched_kernel")
    w = r["work"]
    if n == 0 or "utterances" not in w:
        return None
    return 1e3 * s / w["utterances"]
