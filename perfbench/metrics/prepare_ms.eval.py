"""The device time of a graph decode's setup replay (the program's
``decode.setup`` device span: the features prepared, e.g. AoANet's
refiner or the transformer's encoder, and the bos step), the mean over
the window."""

from perfbench import spans


def read(rec):
    return spans.window_mean_ms(rec, 'decode.setup')
