"""The port's decode (engine/decoding.py through models/api.Captioner)
against the JAX package's ``sample_beam_jit(..., want_logps=False)`` and
``sample_stats_jit`` on the same weights and inputs (float32, CPU).
Sequences must be token-identical; ent_sum / lp_sum agree within 1e-4
(the carried sums differ from the JAX table reductions in summation order
only)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine import decoding
from tests.torch_port_util import inputs, jax_and_port

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one JAX captioner per weight set: its compiled programs are reused
# across the parametrized cases
@pytest.fixture(scope='module', params=[0.0, 4.0], ids=['long', 'early'])
def models(request):
    return jax_and_port(seed=3, eos_boost=request.param) + (
        request.param > 0,)


def _counting(dm):
    """dm with its step_topk calls counted (to see the early exit)."""
    calls = []

    def step_topk(*a, **kw):
        calls.append(1)
        return dm.step_topk(*a, **kw)
    return dataclasses.replace(dm, step_topk=step_topk), calls


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('beam', [3, 5])
@pytest.mark.parametrize('lp', ['', 'wu_0.9', 'avg_0.3'])
@pytest.mark.parametrize('unk', [0, 1])
def test_beam_matches_jax(models, beam, lp, unk):
    jcap, variables, pcap, early = models
    fc, att, am = inputs(B=4, seed=beam)
    opt = {'beam_size': beam, 'sample_n': 1, 'group_size': 1,
           'suppress_UNK': unk, 'length_penalty': lp}
    js, jst, jdone = jcap.sample_beam_jit(
        variables, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(am),
        jax.random.PRNGKey(1), opt, want_logps=False)
    dm, calls = _counting(pcap.bind())
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


@pytest.mark.parametrize('opt,what', [
    ({'beam_size': 4, 'group_size': 2}, 'group_size'),
    ({'beam_size': 3, 'decoding_constraint': 1}, 'decoding_constraint'),
    ({'beam_size': 3, 'remove_bad_endings': 1}, 'remove_bad_endings'),
    ({'beam_size': 1, 'block_trigrams': 1}, 'block_trigrams'),
    ({'beam_size': 1, 'sample_method': 'sample'}, 'sample_method'),
])
def test_off_slice_options_raise(models, opt, what):
    pcap = models[2]
    fc, att, am = _torch(*inputs(B=2))
    with pytest.raises(NotImplementedError, match=what):
        if opt['beam_size'] > 1:
            pcap.sample_beam(fc, att, am, None, opt)
        else:
            pcap.sample_stats(fc, att, am, None, opt)
    if opt['beam_size'] > 1 and what == 'group_size':
        with pytest.raises(NotImplementedError, match='want_logps'):
            pcap.sample_beam(fc, att, am, None, {'beam_size': 3},
                             want_logps=True)


@pytest.mark.parametrize('lp', ['', 'wu_0.9'])
def test_plain_step_routes_match_jax(models, lp):
    """The transformer bound without its fused epilogue takes the engine's
    plain-step routes (the full log-softmax table; in beam search with the
    ancestry table, as the JAX engine's non-fused branch on the CPU)."""
    jcap, variables, pcap, _ = models
    fc, att, am = inputs(B=3, seed=7)
    dm = dataclasses.replace(pcap.bind(), step_topk=None)
    beam = {'beam_size': 3, 'sample_n': 1, 'group_size': 1,
            'suppress_UNK': 1, 'length_penalty': lp}
    js, jst, _ = jcap.sample_beam_jit(
        variables, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(am),
        jax.random.PRNGKey(1), beam, want_logps=False)
    greedy = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}
    jg, jgst = jcap.sample_stats_jit(variables, jnp.asarray(fc),
                                     jnp.asarray(att), jnp.asarray(am),
                                     jax.random.PRNGKey(1), greedy)
    with torch.inference_mode():
        ps, pst, _ = decoding.sample_beam(dm, *_torch(fc, att, am), None,
                                          beam)
        pg, pgst = decoding.sample(dm, *_torch(fc, att, am), None, greedy)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    for got, want in ((pst, jst), (pgst, jgst)):
        for key in ('ent_sum', 'lp_sum'):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=ATOL,
                                       rtol=0)
