"""The random parts of the port's train mode, held by their own
properties (the torch and JAX random streams never agree):

* dropout sites: one train-mode ``forward_tf`` over a one-step caption
  draws as many dropout masks, per model key, as the JAX package's
  train-mode ``forward_tf`` (counted as its ``jax.random.bernoulli``
  calls while it is traced), less the one mask the JAX FC-family cell draws for its seeding
  step and drops unread;
* ``layers.dropout``: the kept share is 1 - p, a kept element is scaled by
  1 / (1 - p), a seed gives one mask, eval and p 0 draw nothing;
* scheduled sampling: at ``ss_prob`` 0 the train-mode pass equals teacher
  forcing; at ``ss_prob`` 1 every token fed from step 1 on is the replay
  of the draws (a coin, then a token from the previous step's output)
  from the same generator state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.models import aoa as paoa
from captioning_tpu_torch.models import harness as pharness
from captioning_tpu_torch.models import layers as players
from captioning_tpu_torch.models import transformer as ptransformer
from tests.torch_port_util import (RNN_MODELS, inputs, jax_and_port,
                                   tiny_opt, tiny_rnn_opt, train_batch)

_FC = ('newfc', 'fc', 'language_model')


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count_port_sites(monkeypatch):
    count = [0]
    real = players.dropout

    def counting(x, p, gen):
        if gen is not None and p > 0:
            count[0] += 1
        return real(x, p, gen)

    for mod in (players, pharness, ptransformer, paoa):
        monkeypatch.setattr(mod, 'dropout', counting)
    return count


# every key, and a hidden logit layer (its dropout is 0.5 whatever
# drop_prob_lm is) on one key of each RNN core family
SITES = ([(m, 1) for m in ('transformer', 'aoa') + RNN_MODELS]
         + [(m, 2) for m in ('updown', 'stackatt', 'adaatt', 'newfc')])


@pytest.mark.parametrize('model,logit_layers', SITES)
def test_dropout_sites_match_jax(model, logit_layers, monkeypatch):
    base = tiny_opt() if model == 'transformer' else tiny_rnn_opt(model)
    for k, v in dict(drop_prob_lm=0.3, dropout=0.2,
                     logit_layers=logit_layers).items():
        setattr(base, k, v)
    jcap, variables, pcap = jax_and_port(opt=base)
    fc, att, am = inputs(2)
    seq = np.array([[0], [3], [5], [0]], 'int32')   # 2 images x 2 captions

    jcount = [0]
    real = jax.random.bernoulli

    def counting(*a, **k):
        jcount[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(jax.random, 'bernoulli', counting)
    # the sites are Python calls: tracing the pass counts them
    jax.eval_shape(lambda v: jcap.forward_tf(
        v, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(seq),
        jnp.asarray(am), 0.0, jax.random.PRNGKey(0), train=True), variables)
    monkeypatch.setattr(jax.random, 'bernoulli', real)
    count = _count_port_sites(monkeypatch)
    pcap.forward_tf(torch.from_numpy(fc), torch.from_numpy(att),
                    torch.from_numpy(seq).long(), torch.from_numpy(am),
                    train=True, generator=torch.Generator().manual_seed(0))
    assert count[0] > 0
    assert count[0] == jcount[0] - (model in _FC)


@pytest.mark.parametrize('p', [0.1, 0.5])
def test_dropout_rate_scale_and_seed(p):
    x = torch.rand(400, 500) + 1.0
    y = players.dropout(x, p, torch.Generator().manual_seed(3))
    kept = y != 0
    n = kept.numel()
    # the kept share is 1 - p within 5 binomial standard deviations
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * np.sqrt(
        p * (1 - p) / n)
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=0, atol=0)
    again = players.dropout(x, p, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    other = players.dropout(x, p, torch.Generator().manual_seed(4))
    assert not torch.equal(y, other)
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    assert players.dropout(x, p, None) is x
    assert players.dropout(x, 0.0, g) is x
    assert torch.equal(g.get_state(), state)     # nothing drawn


def _batch(model):
    opt = tiny_opt() if model == 'transformer' else tiny_rnn_opt(model)
    opt.drop_prob_lm = opt.dropout = 0.0
    _, _, pcap = jax_and_port(opt=opt)
    fc, att, am = inputs(3)
    labels, _ = train_batch(3, 5)
    t = torch.from_numpy
    return pcap, t(fc), t(att), t(labels[..., :-1]), t(am)


@pytest.mark.parametrize('model', ['transformer', 'updown', 'newfc'])
def test_ss_prob_zero_is_teacher_forcing(model):
    pcap, fc, att, seq, am = _batch(model)
    want = pcap.forward_tf(fc, att, seq, am)
    got = pcap.forward_tf(fc, att, seq, am, train=True, ss_prob=0.0,
                          generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('model', ['updown', 'adaatt', 'newfc'])
def test_ss_prob_one_feeds_the_replayed_draws(model, monkeypatch):
    pcap, fc, att, seq, am = _batch(model)
    fed = []
    real = pcap.module.step

    def recording(it, *a, **k):
        fed.append(it.clone())
        return real(it, *a, **k)

    monkeypatch.setattr(pcap.module, 'step', recording)
    lp = pcap.forward_tf(fc, att, seq, am, train=True, ss_prob=1.0,
                         generator=torch.Generator().manual_seed(7))
    flat = seq.reshape(-1, seq.shape[-1])
    assert len(fed) == flat.shape[1]
    assert torch.equal(fed[0], flat[:, 0])
    g = torch.Generator().manual_seed(7)
    for t in range(1, flat.shape[1]):
        coin = torch.rand(flat.shape[0], generator=g)
        drawn = torch.multinomial(lp[:, t - 1].detach().exp(), 1,
                                  generator=g)[:, 0]
        assert bool((coin < 1.0).all())
        assert torch.equal(fed[t], drawn), t
    assert not torch.equal(torch.stack(fed[1:], 1), flat[:, 1:])
