"""The plain references against the program at tiny widths on the CPU,
both in float32 from the same weights: the same beam captions and
sums."""

import types

import pytest
import torch

from perfbench import data, weights
from perfbench.reference import common, decode
from perfbench.tests import tiny


def _captioner(c, host):
    from captioning_tpu_torch.models.api import setup
    opt = c.options
    return setup(types.SimpleNamespace(**opt), data.vocab(opt['vocab_size']),
                 'cpu').load_jax_variables(host)


@pytest.mark.parametrize('name', ['transformer.eval_beam5',
                                  'updown.eval_beam5'])
def test_beam_and_sums(name):
    c = tiny.cell(name)
    opt = c.options
    W, host = weights.make(c.reference().layout(opt, c.config['init']), 11,
                           'cpu')
    cap = _captioner(c, host)
    fc, att, am = (torch.from_numpy(x) for x in data.features(
        6, 5, opt['att_feat_size'], c.config['features']['use_fc'], 12,
        'cpu'))
    beam = dict(c.traffic['eval_kwargs'], beam_size=3)
    seq, stats, _ = cap.sample_beam(fc, att, am, None, beam)
    model = c.reference().Model(common.Weights(W), opt)
    feats = model.prepare(fc, att, am)
    V, L = opt['vocab_size'], opt['max_length']
    best, p = decode.beam_search(model, feats, 6, 3, L, V)
    assert torch.equal(best, seq)
    lp, ent, den, below = decode.caption_sums(model, feats, torch.arange(6),
                                              seq, V, 3)
    assert torch.allclose(lp, stats['lp_sum'], atol=1e-4)
    assert torch.allclose(ent, stats['ent_sum'], atol=1e-4)
    assert torch.allclose(p, lp, atol=1e-4)
    # a beam of 3 keeps no token below its position's 3rd best; one that
    # skips each row's best does
    assert float(below.max()) == 0.0
    bad, _ = decode.beam_search(model, feats, 6, 3, L, V, skip_best=True)
    assert float(decode.caption_sums(model, feats, torch.arange(6), bad, V,
                                     3)[3].max()) > 0.0


@pytest.mark.parametrize('name', ['transformer.eval_beam5',
                                  'updown.eval_beam5'])
def test_cell_on_cpu_agrees(name):
    """A whole run of the cell's loop on the CPU in float32: the check's
    numbers are rounding."""
    c = tiny.cell(name)
    rec = c.loop().run(tiny.context(c, 2 ** 31 + 5))
    assert rec['attempted'] > 0 and rec['failed'] == 0
    assert all(v < 1e-4 for v in rec['check'].values()), rec['check']
