"""Host and transfers: the median host ms of one train step, read from the
program's ``train.step`` root span, for a training cell whose driver
``host_ms`` does not name. None where the program records no such span."""

from aec_bench.metrics.host_ms import median_ms


def read(r):
    return median_ms("train.step")
