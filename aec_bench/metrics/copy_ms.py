"""Host and transfers: the device ms of a tick's copies (host to card and
back), from the trace's memcpy activity."""

from aec_bench.trace import seconds_of


def read(r):
    s, n = seconds_of(r["trace"], "Memcpy HtoD", "Memcpy DtoH")
    w = r["work"]
    if n == 0 or "ticks" not in w:
        return None
    return 1e3 * s / w["ticks"]
