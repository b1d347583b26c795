"""The device time of host-to-device copies a batch, profiled."""

from perfbench import readers


def read(rec):
    return readers.h2d_ms(rec)
