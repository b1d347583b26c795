"""A run with the timed path broken underneath comes out not correct:
the rest of a run (the cell's loop, its check, the comparison with the
cell's limits) at CPU sizes, past the look for a card, once for each
fault the cell can have.

a token altered where the decode produces it; half of the batch left out
(the first half's captions given to the second); a selection that keeps
each row's ranks 2 to k + 1 (the route's top-k: B2 on the transformer's
fused route, B6 over UpDown's candidate table); a beam cut to one (at
these sizes it moves ``beam_gap_mean`` far above a sound run, under the
full-size limit).

One card, so no exchange between chips can be left out; an eval cell has
no state that a step could leave unchanged."""

import pytest
import torch

from perfbench.run import compare
from perfbench.tests import tiny

EVAL = ['transformer.eval_beam5', 'updown.eval_beam5']


def _run(name, seed=2 ** 31 + 9):
    c = tiny.cell(name)
    rec = c.loop().run(tiny.context(c, seed))
    return compare(rec['check'], c.limits)


def _alter(seq):
    """Every caption's first word moved to the next word."""
    seq = seq.clone()
    seq[:, 0] = torch.where(seq[:, 0] > 0, seq[:, 0] % 29 + 1, seq[:, 0])
    return seq


@pytest.mark.parametrize('name', EVAL)
def test_eval_sound(name):
    assert _run(name)[0]


@pytest.mark.parametrize('name', EVAL)
def test_eval_token_altered(name, monkeypatch):
    from captioning_tpu_torch.models import api
    entry = api.DecodeEntries.sample_beam_graphed

    def broken(self, *a, **k):
        seq, stats, done = entry(self, *a, **k)
        return _alter(seq), stats, done
    monkeypatch.setattr(api.DecodeEntries, 'sample_beam_graphed', broken)
    assert not _run(name)[0]


@pytest.mark.parametrize('name', EVAL)
def test_eval_half_batch(name, monkeypatch):
    from captioning_tpu_torch.models import api
    entry = api.DecodeEntries.sample_beam_graphed

    def broken(self, fc, att, am, rng, opt):
        h = fc.shape[0] // 2
        seq, stats, done = entry(self, fc, att, am, rng, opt)
        idx = torch.arange(fc.shape[0]) % max(h, 1)
        return (seq[idx], {k: v[idx] for k, v in stats.items()}, done)
    monkeypatch.setattr(api.DecodeEntries, 'sample_beam_graphed', broken)
    assert not _run(name)[0]


def _skip_best(x, k):
    """Each of the k rows of x [B, k C]: its best entry taken out."""
    B = x.shape[0]
    x = x.view(B, k, -1)
    x = x.scatter(-1, x.argmax(-1, keepdim=True), float('-inf'))
    return x.view(B, -1)


@pytest.mark.parametrize('name', EVAL)
def test_eval_selection_past_k(name, monkeypatch):
    from captioning_tpu_torch.engine import decoding
    from captioning_tpu_torch.models import api
    b2, b6 = api.logit_topk, decoding.topk_lastdim

    def b2_broken(*a, k, **kw):
        tv, ti, rs, en = b2(*a, k=k + 1, **kw)
        return tv[:, 1:], ti[:, 1:], rs, en

    def b6_broken(x, k):
        return b6(_skip_best(x, k).contiguous(), k)
    monkeypatch.setattr(api, 'logit_topk', b2_broken)
    monkeypatch.setattr(decoding, 'topk_lastdim', b6_broken)
    ok, checked = _run(name)
    assert not ok and checked['beam_gap_mean']['value'] > \
        checked['beam_gap_mean']['limit'], checked


@pytest.mark.parametrize('name', EVAL)
def test_eval_beam_cut_to_one(name, monkeypatch):
    """At tiny widths greedy and beam 5 part by less than the full-size
    limit (the card reads 4.1-4.9 nats for the transformer): the number
    moves far above a sound run's."""
    from captioning_tpu_torch.models import api
    entry = api.DecodeEntries.sample_beam_graphed
    sound = _run(name)[1]['beam_gap_mean']['value']

    def greedy(self, fc, att, am, rng, opt):
        return entry(self, fc, att, am, rng, dict(opt, beam_size=1))
    monkeypatch.setattr(api.DecodeEntries, 'sample_beam_graphed', greedy)
    broken = _run(name)[1]['beam_gap_mean']['value']
    assert abs(sound) < 1e-4 and broken > 0.1, (sound, broken)
