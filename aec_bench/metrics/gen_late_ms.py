"""The load generator: the 95th percentile of how late each tick was issued
after its due time (the host clock)."""

from aec_bench.drivers.common import percentile


def read(r):
    late = r["host"].get("late_s")
    return 1e3 * percentile(late, 95) if late else None
