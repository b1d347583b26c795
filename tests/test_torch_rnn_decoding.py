"""The port's decode of the RNN captioners (``RNN_MODELS``: every RNN key,
ShowTell with its LSTM and its GRU) through the engine's plain-step
routes, against the JAX package's ``sample_stats_jit`` and
``sample_beam_jit(..., want_logps=False)`` on the same weights and inputs
(float32, CPU). Sequences must be token-identical; ent_sum / lp_sum agree
within 1e-4 (the carried sums differ from the JAX reductions in summation
order only). With a boosted EOS bias the captions end early and the exact
early exits fire."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine import decoding
from tests.torch_port_util import (RNN_MODELS, inputs, jax_and_port,
                                   tiny_rnn_opt)

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one JAX captioner per (model, weight set): its compiled programs are
# reused across the parametrized cases
@pytest.fixture(scope='module', params=[(m, b) for m in RNN_MODELS
                                        for b in (0.0, 4.0)],
                ids=['%s-%s' % (m, b) for m in RNN_MODELS
                     for b in ('long', 'early')])
def models(request):
    model, boost = request.param
    return jax_and_port(seed=3, eos_boost=boost,
                        opt=tiny_rnn_opt(model)) + (boost > 0,)


def _counting(dm):
    """dm with its plain step calls counted (to see the early exit)."""
    calls = []

    def step(*a, **kw):
        calls.append(1)
        return dm.step(*a, **kw)
    return dataclasses.replace(dm, step=step), calls


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('lp', ['', 'wu_0.9', 'avg_0.3'])
@pytest.mark.parametrize('unk', [0, 1])
def test_beam5_matches_jax(models, lp, unk):
    jcap, variables, pcap, early = models
    fc, att, am = inputs(B=4, seed=5)
    opt = {'beam_size': 5, 'sample_n': 1, 'group_size': 1,
           'suppress_UNK': unk, 'length_penalty': lp}
    js, jst, jdone = jcap.sample_beam_jit(
        variables, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(am),
        jax.random.PRNGKey(1), opt, want_logps=False)
    dm, calls = _counting(pcap.bind())
    assert dm.step_topk is None and dm.beam_reorder is None
    with torch.inference_mode():
        ps, pst, pdone = decoding.sample_beam(dm, *_torch(fc, att, am),
                                              None, opt)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pdone['seq'].numpy(),
                                  np.asarray(jdone['seq']))
    for key in ('ent_sum', 'lp_sum'):
        np.testing.assert_allclose(pst[key].numpy(), np.asarray(jst[key]),
                                   atol=ATOL, rtol=0)
    for key in ('p', 'unaug_p'):
        np.testing.assert_allclose(pdone[key].numpy(),
                                   np.asarray(jdone[key]), rtol=1e-5,
                                   atol=ATOL)
    L = pcap.cfg.seq_length
    assert len(calls) <= L          # bos step + at most L - 1 beam steps
    if early and lp != 'avg_0.3':
        # captions end early: the exact early exit skips steps (the avg
        # penalty's bound keeps short pools open, here and in JAX)
        assert len(calls) < L


def test_beam5_sample_n_matches_jax(models):
    """sample_n == beam size: every beam of the pool is returned."""
    jcap, variables, pcap, _ = models
    fc, att, am = inputs(B=3, seed=6)
    opt = {'beam_size': 5, 'sample_n': 5, 'group_size': 1}
    js, jst, _ = jcap.sample_beam_jit(
        variables, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(am),
        jax.random.PRNGKey(1), opt, want_logps=False)
    ps, pst, _ = pcap.sample_beam(*_torch(fc, att, am), None, opt)
    assert tuple(ps.shape) == (15, pcap.cfg.seq_length)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(pst['lp_sum'].numpy(),
                               np.asarray(jst['lp_sum']), atol=ATOL, rtol=0)


def test_greedy_matches_jax(models):
    jcap, variables, pcap, early = models
    fc, att, am = inputs(B=6, seed=11)
    opt = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}
    js, jst = jcap.sample_stats_jit(variables, jnp.asarray(fc),
                                    jnp.asarray(att), jnp.asarray(am),
                                    jax.random.PRNGKey(1), opt)
    dm, calls = _counting(pcap.bind())
    with torch.inference_mode():
        ps, pst = decoding.sample(dm, *_torch(fc, att, am), None, opt)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    for key in ('ent_sum', 'lp_sum'):
        np.testing.assert_allclose(pst[key].numpy(), np.asarray(jst[key]),
                                   atol=ATOL, rtol=0)
    if early:
        assert (ps == 0).any(dim=1).all()
        assert len(calls) < pcap.cfg.seq_length


def test_greedy_argmax_takes_the_first_maximum():
    """On an exact tie the greedy route picks the lowest index, as
    ``jnp.argmax``: a step whose log-probs tie at 3 and 7 decodes 3."""
    lsm = torch.full((2, 10), -5.0)
    lsm[:, 7] = lsm[:, 3] = -0.1
    lsm[1, 0] = 0.0                             # row 1: EOS wins outright

    def step(it, feats, state, rng, logsoftmax, uniform_t=True,
             beam_width=0):
        return lsm, state
    dm = decoding.DecodeModel(prepare=lambda *a: {}, init_state=lambda n: {},
                              step=step, seq_length=4, vocab_plus=10)
    seq, stats = decoding.sample(dm, torch.zeros(2, 1), torch.zeros(2, 1, 1),
                                 None, None, {'beam_size': 1})
    assert seq.tolist() == [[3, 3, 3, 3], [0, 0, 0, 0]]
    assert stats['lp_sum'].tolist() == pytest.approx([-0.4, 0.0])
