"""Host and transfers: the median host ms of a train step's backward
(``loss.backward()`` on the calling thread), read from the program's
``train.backward`` span. None where the program records none."""

from aec_bench.metrics.host_ms import median_ms


def read(r):
    return median_ms("train.backward")
