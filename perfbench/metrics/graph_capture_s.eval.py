"""The set-up's graph decode builds (the program's ``graph.capture`` span:
the warm decode and the captures), summed."""

from perfbench import spans


def read(rec):
    return spans.setup_sum_s(rec, 'graph.capture')
