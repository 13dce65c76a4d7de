"""Frames run on plain recurrence loops on the card a step: the program's
``lstm.plain_steps`` counter, its change over the window's ``train.step``
root spans summed, over their number. 0 while every recurrence takes its
kernel. None where the program records no ``train.step`` span or has no
such counter."""

from aec_bench.metrics.host_ms import collected

COUNTER = "lstm.plain_steps"


def read(r):
    c = collected()
    steps = [s for s in c["records"] if s.name == "train.step"] if c else []
    if not steps:
        return None
    from aec_tpu_torch.utils import profiling

    if COUNTER not in profiling.counters():
        return None
    return sum((s.counters or {}).get(COUNTER, 0) for s in steps) / len(steps)
