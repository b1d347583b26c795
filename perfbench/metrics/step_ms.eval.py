"""The device time of one step replay of a graph decode (the program's
``decode.step`` device span: the model step, the table passes and the
beam's selection), the mean over the window."""

from perfbench import spans


def read(rec):
    return spans.window_mean_ms(rec, 'decode.step')
