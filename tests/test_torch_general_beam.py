"""The port's general beam body (``engine/decoding.beam_search``: diverse
groups and their penalty, ``decoding_constraint``, ``remove_bad_endings``,
UNK suppression, length penalties, the freeze of the groups outside their
time window) and the winner-logprob replay (``sample_beam(want_logps=
True)``, ``sample_n`` 1 and bdash) against the JAX package's
``sample_beam_jit(..., want_logps=True)`` on the same weights and inputs
(float32, CPU), for the transformer (its per-row step with the ancestry
table, or B1's twin at one group), UpDown and NewFC (the per-row FC
seeding), on a vocab that holds bad-ending words.  Tokens and pools
identical; scores within 1e-5 or 1e-5 relative (a beam that finished
carries a -1000 shift, UNK suppression another); the carried sums within
1e-4 and the replayed tables within 1e-5 (and 1e-6 relative, for the UNK
column), with NaN and -inf where JAX has them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine import decoding
from tests.torch_port_util import (bad_endings_vocab, inputs, jax_and_port,
                                   tiny_opt, tiny_rnn_opt)

CASES = {
    'G1-general-unk-wu': {'beam_size': 3, '_beam_general': 1,
                          'suppress_UNK': 1, 'length_penalty': 'wu_0.9',
                          'temperature': 0.8},
    'G2-unk': {'beam_size': 4, 'group_size': 2, 'diversity_lambda': 0.5,
               'suppress_UNK': 1},
    'G3-avg': {'beam_size': 6, 'group_size': 3, 'diversity_lambda': 0.5,
               'length_penalty': 'avg_0.3'},
    'G1-constraints-n3': {'beam_size': 3, 'decoding_constraint': 1,
                          'remove_bad_endings': 1, 'sample_n': 3},
    'G2-constraints': {'beam_size': 4, 'group_size': 2,
                       'decoding_constraint': 1, 'remove_bad_endings': 1,
                       'temperature': 0.7, 'suppress_UNK': 1},
    'G3-n2': {'beam_size': 6, 'group_size': 3, 'diversity_lambda': 2.0,
              'sample_n': 2},
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, **kw):
    opt = (tiny_opt(**kw) if name == 'transformer'
           else tiny_rnn_opt(name, **kw))
    return jax_and_port(seed=3, opt=opt, vocab=bad_endings_vocab())


# one JAX captioner per model: its compiled programs are reused across the
# parametrized cases
@pytest.fixture(scope='module', params=['transformer', 'updown', 'newfc'])
def models(request):
    return _model(request.param)


def _close(got, want, atol, rtol=0.0):
    """Within tolerance, with -inf and NaN exactly where JAX has them."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=rtol)


def _check(jcap, variables, pcap, opt, B=3, seed=1):
    fc, att, am = inputs(B=B, seed=seed)
    opt = dict({'sample_n': 1, 'group_size': 1}, **opt)
    js, jlp, jdone = jcap.sample_beam_jit(
        variables, *[jnp.asarray(a) for a in (fc, att, am)],
        jax.random.PRNGKey(1), opt, want_logps=True)
    args = [torch.from_numpy(a) for a in (fc, att, am)]
    seq, lp, done = pcap.sample_beam(*args, None, opt, want_logps=True)
    seq_s, stats, _ = pcap.sample_beam(*args, None, opt)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    np.testing.assert_array_equal(seq_s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(done['seq'].numpy(),
                                  np.asarray(jdone['seq']))
    _close(done['p'].numpy(), jdone['p'], 1e-5, rtol=1e-5)
    _close(done['unaug_p'].numpy(), jdone['unaug_p'], 1e-5, rtol=1e-5)
    for key in ('ent_sum', 'lp_sum'):
        _close(done[key].numpy(), jdone[key], 1e-4)
        want = np.asarray(jdone[key])[:, 0]          # group 0
        want = want[:, 0] if opt['sample_n'] == 1 else want.reshape(-1)
        _close(stats[key].numpy(), want, 1e-4)
    # the UNK column holds -1000 + lp: one float32 ulp there is 6e-5
    _close(lp.numpy(), jlp, 1e-5, rtol=1e-6)
    return lp


@pytest.mark.parametrize('case', sorted(CASES))
def test_general_beam_matches_jax(models, case):
    lp = _check(*models, CASES[case])
    if 'constraints' in case:
        assert np.isinf(lp.numpy()).any()        # the constraints fired


def test_frozen_rows_past_the_cache_write_nothing():
    """max_length 7: the transformer's caches hold Tp = 8 slots, and a
    group frozen after its finish steps at t = 8, past them; its write is
    dropped (the JAX scatter drops it), the rest matches."""
    jcap, variables, pcap = _model('transformer', max_length=7)
    assert pcap.cfg.seq_length + 1 == 8
    _check(jcap, variables, pcap, CASES['G2-unk'])
    _check(jcap, variables, pcap, {'beam_size': 3, 'group_size': 3,
                                   'diversity_lambda': 0.5})


@pytest.mark.parametrize('lp', ['', 'wu_0.9'])
def test_general_body_equals_fast_body(models, lp):
    """One group without the scatter constraints: the general body
    (``_beam_general: 1``) and the fast one (the transformer's fused
    epilogue twin, the RNNs' full candidate table) give the same beams."""
    pcap = models[2]
    args = [torch.from_numpy(a) for a in inputs(B=4, seed=7)]
    base = {'beam_size': 4, 'suppress_UNK': 1, 'length_penalty': lp,
            'temperature': 0.9}
    sf, lf, df = pcap.sample_beam(*args, None, base, want_logps=True)
    sg, lg, dg = pcap.sample_beam(*args, None, dict(base, _beam_general=1),
                                  want_logps=True)
    np.testing.assert_array_equal(sf.numpy(), sg.numpy())
    np.testing.assert_array_equal(df['seq'].numpy(), dg['seq'].numpy())
    for key in ('p', 'unaug_p', 'ent_sum', 'lp_sum'):
        np.testing.assert_allclose(df[key].numpy(), dg[key].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(lf.numpy(), lg.numpy(), atol=1e-5, rtol=0)


def test_init_state_gets_the_beam_hint(models):
    """``init_state(B, beam=...)`` reaches the model: True for one group,
    False for diverse groups and for the replay."""
    pcap = models[2]
    dm = pcap.bind()
    seen = []

    def init_state(batch, beam=False):
        seen.append((batch, beam))
        return real(batch, beam)
    real = dm.init_state
    dm = dataclasses.replace(dm, init_state=init_state)
    args = [torch.from_numpy(a) for a in inputs(B=2, seed=3)]
    with torch.inference_mode():
        decoding.sample_beam(dm, *args, None, {'beam_size': 3})
        decoding.sample_beam(dm, *args, None, {'beam_size': 4,
                                               'group_size': 2},
                             want_logps=True)
    assert seen == [(2, True), (2, False), (2, False)]
