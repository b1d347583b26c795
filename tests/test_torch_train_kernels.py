"""The gradients of kernels B3 and B5 through the port's autograd
Functions (``ops/attention.py`` ``AdditiveAttention``, ``ops/lstm.py``
``MaxoutLSTMGates``) against JAX, float32 on the CPU, where the forward is
the twin and the backward recomputes the twin under autograd:

* B3 against ``jax.vjp`` of the JAX ``additive_attention_fused`` (the
  Pallas kernel in interpret mode with its custom VJP), on row-aligned
  queries and on block-shared ones (bw 5: the JAX kernel takes only aligned
  rows, so it gets the features repeated per lane, and the gradients of
  the features are the sums over the lanes); w_alpha is a row of a
  [1, A] weight, as ``AttentionHead`` passes it, and its gradient reaches
  the weight; the mask takes none;
* B5 against ``jax.vjp`` of ``maxout_lstm_gates_ref`` (the JAX cells
  differentiate the plain chain), for both outputs' cotangents, and
  through the Att2in2 core, where ``c_prev`` is a ``.contiguous()`` slice
  of the [N, 1, H] state.

No kernel launch is counted on the CPU, forward or backward.  atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.ops import attention as jattn
from captioning_tpu.ops import lstm as jlstm
from captioning_tpu_torch.ops import attention as pattn
from captioning_tpu_torch.ops import lstm as plstm

ATOL = 1e-5
H, A, M = 20, 12, 7


def _b3_case(nb, bw, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype('float32')
    att_h, att, p_att = f(nb * bw, A), f(nb, M, H), f(nb, M, A)
    w, b = (f(A) / np.sqrt(A)).astype('float32'), f(1) * 0.1
    am = (np.arange(M)[None] < rng.randint(2, M + 1, (nb, 1))
          ).astype('float32')
    g = f(nb * bw, H)
    return att_h, att, p_att, am, w, b, g


@pytest.mark.parametrize('bw', [1, 5])
def test_additive_attention_grads_match_jax_vjp(bw):
    nb = 3
    att_h, att, p_att, am, w, b, g = _b3_case(nb, bw, seed=bw)
    rep = lambda x: np.repeat(x, bw, axis=0)
    out, vjp = jax.vjp(
        lambda *a: jattn.additive_attention_fused(*a, 8, True),
        jnp.asarray(att_h), jnp.asarray(rep(att)), jnp.asarray(rep(p_att)),
        jnp.asarray(rep(am)), jnp.asarray(w), jnp.asarray(b[0]))
    dh, datt, dp, _, dw, db = vjp(jnp.asarray(g))
    lanes = lambda d: np.asarray(d).reshape(nb, bw, *d.shape[1:]).sum(1)

    t = lambda x: torch.from_numpy(x.copy()).requires_grad_(True)
    th, tatt, tp = t(att_h), t(att), t(p_att)
    weight = t(w[None])                    # alpha_net.weight [1, A]
    tb = t(b)
    mask = torch.from_numpy(am)
    launches = pattn.additive_attention_fused.launches
    got = pattn.additive_attention_fused(th, tatt, tp, mask, weight[0], tb)
    got.backward(torch.from_numpy(g))
    assert pattn.additive_attention_fused.launches == launches
    assert got.grad_fn.name().startswith('AdditiveAttention')
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=ATOL, rtol=0)
    for name, mine, want in (('att_h', th.grad, dh),
                             ('att_feats', tatt.grad, lanes(datt)),
                             ('p_att_feats', tp.grad, lanes(dp)),
                             ('w_alpha', weight.grad[0], dw),
                             ('b_alpha', tb.grad[0], db)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)
    assert mask.grad is None


def test_additive_attention_without_grad_takes_no_function():
    att_h, att, p_att, am, w, b, _ = _b3_case(2, 1, seed=9)
    t = torch.from_numpy
    out = pattn.additive_attention_fused(t(att_h), t(att), t(p_att), t(am),
                                         t(w), t(b))
    assert out.grad_fn is None
    with torch.no_grad():
        x = t(att_h).requires_grad_(True)
        assert pattn.additive_attention_fused(
            x, t(att), t(p_att), t(am), t(w), t(b)).grad_fn is None


@pytest.mark.parametrize('N', [1, 9])
def test_maxout_gates_grads_match_jax_vjp(N):
    Hh = 16
    rng = np.random.RandomState(N)
    s = (rng.randn(N, 5 * Hh) * 2).astype('float32')
    c = rng.randn(N, Hh).astype('float32')
    gh, gc = (rng.randn(N, Hh).astype('float32') for _ in range(2))
    (h, nc), vjp = jax.vjp(jlstm.maxout_lstm_gates_ref, jnp.asarray(s),
                           jnp.asarray(c))
    ds, dc = vjp((jnp.asarray(gh), jnp.asarray(gc)))
    ts = torch.from_numpy(s).requires_grad_(True)
    tc = torch.from_numpy(c).requires_grad_(True)
    launches = plstm.maxout_lstm_gates_fused.launches
    got_h, got_c = plstm.maxout_lstm_gates_fused(ts, tc)
    torch.autograd.backward([got_h, got_c],
                            [torch.from_numpy(gh), torch.from_numpy(gc)])
    assert plstm.maxout_lstm_gates_fused.launches == launches
    assert got_h.grad_fn.name().startswith('MaxoutLSTMGates')
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(h),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(nc),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ds), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(dc), atol=ATOL,
                               rtol=0)


def test_cell_state_gradient_flows_through_contiguous():
    """d(out, h, c) / d(state c) of the Att2in2 core, whose chain takes
    ``c_prev.contiguous()`` of the [N, 1, H] state, against ``jax.grad`` of
    the JAX core."""
    from captioning_tpu.models import harness as jharness
    from captioning_tpu_torch.models import harness as pharness
    from captioning_tpu_torch.models.config import ModelConfig
    from tests.test_torch_maxout_lstm import _port_load
    E, Hh, Aa, Mm, nb, bw = 20, 24, 12, 5, 3, 5
    N = nb * bw
    rng = np.random.RandomState(3)
    f = lambda *shape: rng.randn(*shape).astype('float32')
    xt, h, c = f(N, E), f(N, 1, Hh), f(N, 1, Hh)
    att, p_att = f(nb, Mm, Hh), f(nb, Mm, Aa)
    am = np.ones((nb, Mm), 'float32')
    jcfg = jharness.ModelConfig(caption_model='att2in2', vocab_size=29,
                                input_encoding_size=E, rnn_size=Hh,
                                att_hid_size=Aa, drop_prob_lm=0.0)
    jcore = jharness.make_core(jcfg)
    jfeats = {'att_feats': jnp.asarray(att), 'p_att_feats': jnp.asarray(p_att),
              'att_masks': jnp.asarray(am)}
    params = jcore.init(jax.random.PRNGKey(1), jnp.asarray(xt), jfeats,
                        {'h': jnp.asarray(h), 'c': jnp.asarray(c)},
                        False)['params']

    def jloss(c_):
        out, st = jcore.apply({'params': params}, jnp.asarray(xt), jfeats,
                              {'h': jnp.asarray(h), 'c': c_}, False)
        return out.sum() + (st['c'] ** 2).sum()

    want = jax.grad(jloss)(jnp.asarray(c))
    pcore = _port_load(pharness.make_core(ModelConfig(
        caption_model='att2in2', vocab_size=29, input_encoding_size=E,
        rnn_size=Hh, att_hid_size=Aa)), params)
    tc = torch.from_numpy(c).requires_grad_(True)
    out, st = pcore(torch.from_numpy(xt),
                    {'att_feats': torch.from_numpy(att),
                     'p_att_feats': torch.from_numpy(p_att),
                     'att_masks': torch.from_numpy(am)},
                    {'h': torch.from_numpy(h), 'c': tc})
    (out.sum() + (st['c'] ** 2).sum()).backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
