"""The host wall of a graph decode call, the mean over the window."""

from perfbench import readers


def read(rec):
    return readers.span_mean_ms(rec, 'decode')
