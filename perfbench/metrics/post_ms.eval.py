"""The host wall of a batch's post-processing (the program's ``eval.post``
span: the captions read back, the strings, the entries), the mean over
the window."""

from perfbench import spans


def read(rec):
    return spans.window_mean_ms(rec, 'eval.post')
