"""Cells at widths and sizes a CPU test holds: the manifest's cell with
its configuration cut and its traffic shrunk, run on the CPU in float32
(the program's kernels take their plain twins there)."""

import time

from perfbench import harness
from perfbench.run import Context

TINY = {
    'transformer': dict(vocab_size=30, d_model=32, d_ff=48, num_att_heads=4,
                        N_enc=2, N_dec=2, att_feat_size=12, fc_feat_size=12,
                        max_length=8, input_encoding_size=16, rnn_size=32),
    'updown': dict(vocab_size=30, input_encoding_size=20, rnn_size=24,
                   att_hid_size=12, att_feat_size=12, fc_feat_size=12,
                   max_length=8),
}
TRAFFIC = dict(images=40, batch_size=16, batch_images=4, check_images=8,
               ref_len=6, label_len=6)


def cell(name):
    c = harness.Cell(name)
    c.config['options'].update(TINY[c.config['reference']])
    c.config['options']['compute_dtype'] = 'float32'
    c.traffic.update({k: v for k, v in TRAFFIC.items() if k in c.traffic})
    return c


def context(c, seed, seconds=0.5):
    return Context(c, seed, seconds, 0, device='cpu', t0=time.time())
