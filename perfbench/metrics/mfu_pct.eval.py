"""The eval window's model FLOPs a second against the card's bf16 peak."""

from perfbench import readers


def read(rec):
    return readers.mfu_pct(rec, 'eval')
