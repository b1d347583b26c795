"""Captions eval_split returned over the window's wall."""

from perfbench import readers


def read(rec):
    return readers.rate(rec, 'eval')
