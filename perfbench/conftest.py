"""Tiny widths of the configurations that ``tests/tiny.py`` does not list,
added to its table, so that every test that runs each cell of the
manifest at CPU sizes finds them."""

from perfbench.tests import tiny

# AoANet: rnn 32 in 4 heads, word embedding 16, 12-wide regions; the
# refiner keeps its 6 layers
tiny.TINY.setdefault('aoa', dict(vocab_size=30, input_encoding_size=16,
                                 rnn_size=32, num_heads=4, att_feat_size=12,
                                 fc_feat_size=12, max_length=8))
