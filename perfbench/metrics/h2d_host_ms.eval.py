"""The host wall of a batch's copy to the device (the program's
``eval.h2d`` span), the mean over the window."""

from perfbench import spans


def read(rec):
    return spans.window_mean_ms(rec, 'eval.h2d')
