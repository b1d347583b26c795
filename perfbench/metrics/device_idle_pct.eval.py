"""The share of the profiled eval sub-window in which no kernel ran."""

from perfbench import readers


def read(rec):
    return readers.device_idle_pct(rec, 'eval')
