"""The maxout-LSTM gate chain of the port (``ops/lstm.py``) and the port's
maxout cells against the JAX package, on the same numpy inputs, float32 on
the CPU, where the wrapper runs its twin: the twin against
``maxout_lstm_gates_ref`` and the Pallas kernel in interpret mode (row
counts no multiple of its 128-row block), and ``MaxoutLSTMCell`` and the
Att2in2 / Att2all2 cores against the JAX modules on the same weights.
atol 1e-6 for the chain (the same float32 ops, elementwise), 1e-5 for the
cells (their GEMMs sum in another order).  In bf16 the twin rounds at the
points the CUDA kernel rounds at: each op of the chain, in the dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.models import harness as jharness
from captioning_tpu.ops import lstm as jlstm
from captioning_tpu.utils.misc import _flatten_tree
from captioning_tpu_torch.models import harness as pharness
from captioning_tpu_torch.models.config import ModelConfig
from captioning_tpu_torch.ops.lstm import (maxout_lstm_gates_fused,
                                           maxout_lstm_gates_ref)
from captioning_tpu_torch.utils.weights import _harness_name


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(N, H, seed):
    rng = np.random.RandomState(seed)
    s = (rng.randn(N, 5 * H) * 2).astype('float32')
    c = rng.randn(N, H).astype('float32')
    return s, c


@pytest.mark.parametrize('N', [1, 7, 130, 257])
@pytest.mark.parametrize('H', [24, 40])
def test_twin_matches_jax_ref_and_pallas_interpret(N, H):
    s, c = _case(N, H, seed=N + H)
    want_ref = jlstm.maxout_lstm_gates_ref(jnp.asarray(s), jnp.asarray(c))
    want_pl = jlstm.maxout_lstm_gates_fused(jnp.asarray(s), jnp.asarray(c),
                                            interpret=True)
    got = maxout_lstm_gates_ref(torch.from_numpy(s), torch.from_numpy(c))
    launches = maxout_lstm_gates_fused.launches
    wrapped = maxout_lstm_gates_fused(torch.from_numpy(s),
                                      torch.from_numpy(c))
    assert maxout_lstm_gates_fused.launches == launches
    for g, w in zip(got, want_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)
    for g, w in zip(wrapped, want_pl):
        assert tuple(g.shape) == (N, H) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_bf16_twin_rounds_after_every_op():
    """The rounding points the CUDA kernel mirrors: each sigmoid, f * c,
    i * g, their sum, tanh and o * tanh, each rounded to bf16."""
    s, c = _case(33, 40, seed=1)
    bf = torch.bfloat16
    sb, cb = torch.from_numpy(s).to(bf), torch.from_numpy(c).to(bf)
    h, nc = maxout_lstm_gates_fused(sb, cb)
    assert h.dtype == nc.dtype == bf

    def r(x):
        return x.to(bf).float()
    H = 40
    sf, cf = sb.float(), cb.float()
    i, f, o = (r(torch.sigmoid(sf[:, k * H:(k + 1) * H])) for k in range(3))
    g = torch.maximum(sf[:, 3 * H:4 * H], sf[:, 4 * H:])
    want_c = r(r(f * cf) + r(i * g))
    want_h = r(o * r(torch.tanh(want_c)))
    assert torch.equal(nc.float(), want_c)
    assert torch.equal(h.float(), want_h)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    s, c = (torch.from_numpy(a) for a in _case(6, 8, seed=0))
    with pytest.raises(ValueError, match=r'\[N, 5H\]'):
        maxout_lstm_gates_fused(s[:, :39], c)
    with pytest.raises(ValueError, match=r'\[N, 5H\]'):
        maxout_lstm_gates_fused(s[:5], c)
    # a state slice of a multi-layer [N, L, H] state is not contiguous:
    # the cells pass c.contiguous(), and the CPU refuses what the card would
    state = torch.zeros(6, 3, 8)
    with pytest.raises(ValueError, match='contiguous'):
        maxout_lstm_gates_fused(s, state[:, 1])
    with pytest.raises(ValueError, match='float32'):
        maxout_lstm_gates_fused(s, c.double())


def _port_load(module, jax_params):
    """The port module's state_dict from a JAX module's param tree, by the
    weight bridge's name map."""
    flat = _flatten_tree({'params': jax.tree.map(np.asarray, jax_params)})
    sd = {}
    for key, value in flat.items():
        t = torch.from_numpy(np.array(value, np.float32))
        sd[_harness_name(key)] = (t.T.contiguous() if key.endswith('/kernel')
                                  else t)
    module.load_state_dict(sd, strict=True)
    return module


@pytest.mark.parametrize('in_features', [20, 24])
def test_maxout_cell_matches_jax(in_features):
    H, N = 24, 9
    rng = np.random.RandomState(in_features)
    x = rng.randn(N, in_features).astype('float32')
    h = rng.randn(N, H).astype('float32')
    c = rng.randn(N, H).astype('float32')
    jcell = jharness.MaxoutLSTMCell(H, 0.0)
    params = jcell.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(h),
                        jnp.asarray(c), False)['params']
    _, want_h, want_c = jcell.apply({'params': params}, jnp.asarray(x),
                                    jnp.asarray(h), jnp.asarray(c), False)
    pcell = _port_load(pharness.MaxoutLSTMCell(in_features, H), params)
    with torch.no_grad():
        got_h, got_c = pcell(torch.from_numpy(x), torch.from_numpy(h),
                             torch.from_numpy(c))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('model', ['att2in2', 'att2all2'])
@pytest.mark.parametrize('bw', [1, 5])
def test_att2_cores_match_jax(model, bw):
    """The Att2in2 chain (a2c added into s[:, 3H:] first) and the Att2all2
    chain, through the wrapper, against the JAX cores."""
    E, H, A, M, nb = 20, 24, 12, 5, 3
    N = nb * bw
    rng = np.random.RandomState(bw)
    f = lambda *shape: rng.randn(*shape).astype('float32')
    xt, h, c = f(N, E), f(N, 1, H), f(N, 1, H)
    att, p_att = f(nb, M, H), f(nb, M, A)
    am = np.ones((nb, M), 'float32')
    am[1, 3:] = 0
    jcfg = jharness.ModelConfig(caption_model=model, vocab_size=29,
                                input_encoding_size=E, rnn_size=H,
                                att_hid_size=A, drop_prob_lm=0.0)
    jcore = jharness.make_core(jcfg)
    jfeats = {'att_feats': jnp.asarray(att), 'p_att_feats': jnp.asarray(p_att),
              'att_masks': jnp.asarray(am)}
    jstate = {'h': jnp.asarray(h), 'c': jnp.asarray(c)}
    params = jcore.init(jax.random.PRNGKey(1), jnp.asarray(xt), jfeats,
                        jstate, False)['params']
    want_out, want_st = jcore.apply({'params': params}, jnp.asarray(xt),
                                    jfeats, jstate, False)
    pcfg = ModelConfig(caption_model=model, vocab_size=29,
                       input_encoding_size=E, rnn_size=H, att_hid_size=A)
    pcore = _port_load(pharness.make_core(pcfg), params)
    launches = maxout_lstm_gates_fused.launches
    with torch.no_grad():
        out, st = pcore(torch.from_numpy(xt),
                        {'att_feats': torch.from_numpy(att),
                         'p_att_feats': torch.from_numpy(p_att),
                         'att_masks': torch.from_numpy(am)},
                        {'h': torch.from_numpy(h), 'c': torch.from_numpy(c)})
    assert maxout_lstm_gates_fused.launches == launches      # CPU: the twin
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5,
                               rtol=0)
    for key in ('h', 'c'):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(want_st[key]),
                                   atol=1e-5, rtol=0)
