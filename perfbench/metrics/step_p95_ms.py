"""The 95th percentile of the intervals between consecutive completions."""

from perfbench import readers


def read(rec):
    return readers.p95_interval_ms(rec)
