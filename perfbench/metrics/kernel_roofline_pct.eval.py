"""The hand-written kernels' least time over their device time, eval."""

from perfbench import readers


def read(rec):
    return readers.kernel_roofline_pct(rec, 'eval')
