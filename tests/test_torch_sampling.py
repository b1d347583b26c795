"""The port's sampling routes (``engine/decoding.sample`` and
``diverse_sample``) against the JAX package's on the same weights and
inputs (float32, CPU), for the transformer, UpDown and NewFC: every
sample method (greedy, sample, gumbel, top-k, top-p) with the JAX draws of
the same step keys handed to the port (``torch_port_util.jax_draws``), so
the two streams need not agree.

* the per-step tables (``sample_dynamic_jit``, the JAX program that serves
  every method) with ``decoding_constraint``, ``remove_bad_endings`` and
  ``block_trigrams`` on a vocab that holds bad-ending words: tokens
  identical, tables within 1e-5, -inf and NaN where JAX has them;
* the carried stats (``sample_stats_jit``): tokens identical, the sums
  within 1e-4 (NaN where a constraint put -inf in a row, as in JAX);
* diverse sampling (``sample_jit`` with ``group_size > 1``): staggered
  groups, the batch-pooled penalty, the constraints and the trigram block:
  tokens identical, sampled logprobs within 1e-5;
* ``sample_next_word`` against both JAX forms (the static sampler and the
  traced-method one) on tables holding -inf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.engine import decoding as jdec
from captioning_tpu_torch.engine import decoding
from tests.torch_port_util import (bad_endings_vocab, inputs, jax_and_port,
                                   jax_draws, tiny_rnn_opt)

ATOL, SUM_ATOL = 1e-5, 1e-4
METHODS = ['greedy', 'sample', 'gumbel', 'top3', 'top0.8']


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one JAX captioner per model: its compiled programs are reused across the
# parametrized cases
@pytest.fixture(scope='module', params=['transformer', 'updown', 'newfc'])
def models(request):
    opt = None if request.param == 'transformer' else tiny_rnn_opt(
        request.param)
    return jax_and_port(seed=3, opt=opt, vocab=bad_endings_vocab())


def _jax_in(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, atol):
    """Within atol, with -inf and NaN exactly where JAX has them."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, rtol=0)


@pytest.mark.parametrize('method', METHODS)
def test_sample_tables_match_jax(models, method):
    jcap, variables, pcap = models
    fc, att, am = inputs(B=3, seed=1)
    opt = {'sample_method': method, 'sample_n': 2, 'temperature': 0.8,
           'beam_size': 1, 'group_size': 1, 'decoding_constraint': 1,
           'remove_bad_endings': 1, 'block_trigrams': 1}
    js, jlp = jcap.sample_dynamic_jit(variables, *_jax_in(fc, att, am),
                                      jax.random.PRNGKey(4), opt)
    seq, lp = pcap.sample(*_torch(fc, att, am),
                          jax_draws(4, pcap.cfg.seq_length), opt)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    assert np.isinf(np.asarray(jlp)).any()      # the constraints fired
    _close(lp.numpy(), jlp, ATOL)


@pytest.mark.parametrize('constrained', [0, 1])
@pytest.mark.parametrize('method', METHODS)
def test_sample_stats_match_jax(models, method, constrained):
    jcap, variables, pcap = models
    fc, att, am = inputs(B=3, seed=2)
    opt = {'sample_method': method, 'sample_n': 2, 'temperature': 0.7,
           'beam_size': 1, 'group_size': 1,
           'decoding_constraint': constrained}
    js, jst = jcap.sample_stats_jit(variables, *_jax_in(fc, att, am),
                                    jax.random.PRNGKey(6), opt)
    seq, st = pcap.sample_stats(*_torch(fc, att, am),
                                jax_draws(6, pcap.cfg.seq_length), opt)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    for key in ('ent_sum', 'lp_sum'):
        _close(st[key].numpy(), jst[key], SUM_ATOL)
    # entropy of a row holding -inf is NaN (0 * -inf), in JAX as here
    assert np.isnan(st['ent_sum'].numpy()).any() == bool(constrained)


DIVERSE = {
    'dgreedy3-trigrams': {'sample_method': 'greedy', 'group_size': 3,
                          'diversity_lambda': 0.5, 'block_trigrams': 1},
    'dsample2-constraints': {'sample_method': 'sample', 'group_size': 2,
                             'diversity_lambda': 1.0, 'temperature': 0.8,
                             'decoding_constraint': 1,
                             'remove_bad_endings': 1},
    'dtop3': {'sample_method': 'top3', 'group_size': 3,
              'diversity_lambda': 0.5},
    'dgumbel2': {'sample_method': 'gumbel', 'group_size': 2,
                 'diversity_lambda': 0.5, 'temperature': 0.9},
    'dtop0.8': {'sample_method': 'top0.8', 'group_size': 2,
                'diversity_lambda': 0.5},
}


@pytest.mark.parametrize('case', sorted(DIVERSE))
def test_diverse_sample_matches_jax(models, case):
    jcap, variables, pcap = models
    fc, att, am = inputs(B=3, seed=1)
    opt = dict(DIVERSE[case], beam_size=1)
    G = opt['group_size']
    js, jlp = jcap.sample_jit(variables, *_jax_in(fc, att, am),
                              jax.random.PRNGKey(5), opt)
    seq, lp = pcap.sample(*_torch(fc, att, am),
                          jax_draws(5, pcap.cfg.seq_length + G - 1), opt)
    assert tuple(seq.shape) == (3 * G, pcap.cfg.seq_length)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('method,temp', [
    ('greedy', 1.0), ('sample', 1.0), ('sample', 0.7), ('gumbel', 0.9),
    ('top3', 1.0), ('top1', 1.0), ('top0.8', 0.9), ('top0.5', 1.0)])
def test_sample_next_word_matches_both_jax_forms(method, temp):
    """One step on [6, 31] tables (two entries -inf in some rows, as the
    constraints leave them), the noise of one JAX key."""
    from captioning_tpu.models.api import Captioner
    rng = np.random.RandomState(3)
    lp = rng.randn(6, 31).astype('float32') * 2
    lp[1, 4] = lp[3, [0, 7]] = -np.inf
    lp = np.array(jax.nn.log_softmax(jnp.asarray(lp), axis=-1))
    key = jax.random.PRNGKey(9)

    def draw(kind, t, shape):
        fn = jax.random.uniform if kind == 'uniform' else jax.random.gumbel
        return torch.from_numpy(np.array(fn(key, tuple(shape))))

    ws, wlp = jdec.sample_next_word(key, jnp.asarray(lp), method, temp)
    dyn = Captioner._dynamic_sample_params(method, temp)
    ds, _ = jdec.sample_next_word_dynamic(
        key, jnp.asarray(lp), dyn['method_id'], dyn['temperature'],
        dyn['top_k'], dyn['top_p'])
    it, got = decoding.sample_next_word(torch.from_numpy(lp), method, temp,
                                        draw, 0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ds))
    np.testing.assert_allclose(got.numpy(), np.asarray(wlp), atol=ATOL,
                               rtol=0)
