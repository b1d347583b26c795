"""The set-up's weight installs (the program's ``model.install`` span:
``Captioner._install``), summed."""

from perfbench import spans


def read(rec):
    return spans.setup_sum_s(rec, 'model.install')
