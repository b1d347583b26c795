"""The port's TransformerCaptioner against the JAX module on the same
weights and inputs (2 layers, d_model 32, 4 heads, vocab 30, 5 regions,
float32 on the CPU): prepare_feature, per-step log-probs and caches over
several uniform-t steps with and without beam ancestry, the return_hidden
state, and eval forward_tf.  atol 1e-5 (float32, summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import inputs, jax_and_port

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _jax_prepare(jcap, variables, fc, att, am):
    m = jcap.module
    return m.apply(variables, jnp.asarray(fc), jnp.asarray(att),
                   jnp.asarray(am), False, method=type(m).prepare_feature)


@pytest.mark.parametrize('use_bn', [0, 1, 2])
def test_prepare_feature_matches_jax(use_bn):
    jcap, variables, pcap = jax_and_port(use_bn=use_bn)
    if use_bn:
        # non-trivial running stats and affine params for the eval branch
        rng = np.random.RandomState(1)
        for coll, name, f in (('batch_stats', 'mean', 0.5),
                              ('batch_stats', 'var', 1.0),
                              ('params', 'scale', 0.3),
                              ('params', 'bias', 0.3)):
            for bn in [b for b in ('att_bn_in', 'att_bn_out')
                       if b in variables[coll]]:
                a = variables[coll][bn][name]
                variables[coll][bn][name] = (
                    np.abs(rng.randn(*a.shape)) * f + (name == 'var')
                    ).astype('float32')
        pcap.load_jax_variables(variables)
    fc, att, am = inputs()
    want = _jax_prepare(jcap, variables, fc, att, am)
    got = pcap.module.prepare_feature(torch.from_numpy(fc),
                                      torch.from_numpy(att),
                                      torch.from_numpy(am))
    _close(got['memory'], want['memory'])


@pytest.mark.parametrize('bw', [0, 3])
def test_steps_logprobs_caches_hidden_match_jax(bw):
    jcap, variables, pcap = jax_and_port()
    jm, pm = jcap.module, pcap.module
    B = 2
    fc, att, am = inputs(B=B)
    feats_j = _jax_prepare(jcap, variables, fc, att, am)
    feats_p = pm.prepare_feature(torch.from_numpy(fc), torch.from_numpy(att),
                                 torch.from_numpy(am))
    N = B * max(bw, 1)
    st_j = jm.init_state(N, beam=True)
    st_p = pm.init_state(N)
    assert tuple(st_p['k0'].shape) == tuple(st_j['k0'].shape)
    rng = np.random.RandomState(0)
    if bw:
        anc = np.broadcast_to((np.arange(N) % bw)[:, None],
                              st_p['k0'].shape[:2]).astype('int32')
        st_j = dict(st_j, anc=jnp.asarray(anc))
        st_p = dict(st_p, anc=torch.from_numpy(anc.copy()))
    for t in range(5):
        if bw and t:
            # a beam reorder: rows inherit a parent within their block
            parent = (np.arange(N) // bw) * bw + rng.randint(0, bw, N)
            st_j = dict(st_j, t=st_j['t'][parent], anc=st_j['anc'][parent])
            st_p = dict(st_p, anc=st_p['anc'][torch.from_numpy(parent)])
        it = rng.randint(1, 30, N).astype('int32')
        for hidden in (True, False):
            # return_hidden first: the cache write is idempotent per step
            out_j, nst_j = jm.apply(
                variables, jnp.asarray(it), feats_j, st_j, False,
                not hidden, True, bw, hidden, method=type(jm).step)
            out_p, nst_p = pm.step(torch.from_numpy(it).long(), feats_p,
                                   st_p, not hidden, True, bw, hidden)
            _close(out_p, out_j)
        st_j, st_p = nst_j, nst_p
        assert st_p['t'] == int(st_j['t'][0])
        for i in range(2):
            _close(st_p['k%d' % i], st_j['k%d' % i])
            _close(st_p['v%d' % i], st_j['v%d' % i])
        if bw:
            np.testing.assert_array_equal(st_p['anc'].numpy(),
                                          np.asarray(st_j['anc']))


def test_per_row_t_is_not_ported():
    _, _, pcap = jax_and_port()
    fc, att, am = inputs(B=2)
    pm = pcap.module
    feats = pm.prepare_feature(torch.from_numpy(fc), torch.from_numpy(att),
                               torch.from_numpy(am))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        pm.step(torch.zeros(2, dtype=torch.long), feats, pm.init_state(2),
                uniform_t=False)


@pytest.mark.parametrize('seq_per_img', [1, 2])
def test_forward_tf_matches_jax(seq_per_img):
    jcap, variables, pcap = jax_and_port()
    B, T = 3, 7
    fc, att, am = inputs(B=B)
    rng = np.random.RandomState(2)
    seq = rng.randint(1, 30, (B * seq_per_img, T)).astype('int32')
    seq[:, 0] = 0
    seq[0, 4:] = 0                 # an ended caption (eos then pads)
    want = jcap.forward_tf(variables, jnp.asarray(fc), jnp.asarray(att),
                           jnp.asarray(seq), jnp.asarray(am))
    got = pcap.forward_tf(torch.from_numpy(fc), torch.from_numpy(att),
                          torch.from_numpy(seq).long(), torch.from_numpy(am))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
