"""The gradient sum of a data-parallel step on rank 0's host: the median ms
of the program's ``train.allreduce`` span (``sum_gradients`` in
``train/loop._global_update``: the flat bucket's all-reduce enqueued, the
gradients scattered back). None where the program records no such span."""

from aec_bench.metrics.host_ms import median_ms


def read(r):
    return median_ms("train.allreduce")
