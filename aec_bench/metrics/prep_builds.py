"""Serving kernel: K3's prepared launches built because ``hop.prepare``'s
cache had no entry, per 1,000 calls: the ``hop.prepare.builds`` counter's
change over each of the window's ``serving.step`` root spans, summed. A
sound serving loop reads 0; a rebuild on every call (an ``erb`` that is not
float32 on the card, a weight changed between calls) reads 1,000. None where
the program records no ``serving.step`` span."""

from aec_bench.metrics.host_ms import collected


def read(r):
    c = collected()
    steps = [s for s in c["records"] if s.name == "serving.step"] if c else []
    if not steps:
        return None
    builds = sum((s.counters or {}).get("hop.prepare.builds", 0) for s in steps)
    return 1e3 * builds / len(steps)
