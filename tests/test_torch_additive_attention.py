"""Kernel B3's plain twin and the plain attention math of the port
(``ops/attention.py``, ``models/layers.additive_attention``) against the
JAX package on the same numpy inputs, float32 on the CPU, where the
wrapper runs its twin: against ``additive_attention_ref`` and the Pallas
kernel in interpret mode for row-aligned queries (bw = 1), and against the
block-shared branch of ``layers.additive_attention`` for bw in {2, 5}.
atol 1e-5: the same float32 math up to summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.models import layers as jlayers
from captioning_tpu.ops import attention as jattn
from captioning_tpu_torch.models import layers as players
from captioning_tpu_torch.ops import attention as pattn

ATOL = 1e-5
H, A = 20, 12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(nb, bw, M, mask, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype('float32')
    att_h, att, p_att = f(nb * bw, A), f(nb, M, H), f(nb, M, A)
    w = (f(A) / np.sqrt(A)).astype('float32')
    b = f(1) * 0.1
    am = None
    if mask == 'ones':
        am = np.ones((nb, M), 'float32')
    elif mask == 'ragged':
        am = (np.arange(M)[None] < rng.randint(1, M + 1, (nb, 1))
              ).astype('float32')
    elif mask == 'zero':
        # ragged rows plus one image with no valid region: its output is 0
        am = (np.arange(M)[None] < rng.randint(1, M + 1, (nb, 1))
              ).astype('float32')
        am[nb // 2] = 0
    return att_h, att, p_att, am, w, b


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


MASKS = ['none', 'ones', 'ragged', 'zero']


@pytest.mark.parametrize('M', [5, 13])
@pytest.mark.parametrize('mask', MASKS)
def test_twin_matches_jax_ref_and_pallas_interpret(M, mask):
    att_h, att, p_att, am, w, b = _case(7, 1, M, mask, seed=M)
    want_ref = jattn.additive_attention_ref(_j(att_h), _j(att), _j(p_att),
                                            _j(am), _j(w), _j(b[0]))
    jmask = am if am is not None else np.ones(att.shape[:2], 'float32')
    want_pl = jattn.additive_attention_fused(
        _j(att_h), _j(att), _j(p_att), _j(jmask), _j(w), _j(b[0]), 8, True)
    got = pattn.additive_attention_ref(_t(att_h), _t(att), _t(p_att), _t(am),
                                       _t(w), _t(b))
    launches = pattn.additive_attention_fused.launches
    wrapped = pattn.additive_attention_fused(_t(att_h), _t(att), _t(p_att),
                                             _t(am), _t(w), _t(b))
    assert pattn.additive_attention_fused.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(wrapped.numpy(), np.asarray(want_pl),
                               atol=ATOL, rtol=0)
    if mask == 'zero':
        assert not wrapped[7 // 2].any()


def _jax_plain(att_h, att, p_att, am, w, b):
    """``layers.additive_attention`` with the query already projected and
    alpha_net as a plain affine map."""
    return jlayers.additive_attention(
        _j(att_h), _j(att), _j(p_att), _j(am), lambda x: x,
        lambda d: d @ _j(w)[:, None] + _j(b))


@pytest.mark.parametrize('bw', [2, 5])
@pytest.mark.parametrize('M', [5, 13])
@pytest.mark.parametrize('mask', MASKS)
def test_twin_matches_jax_block_shared(bw, M, mask):
    att_h, att, p_att, am, w, b = _case(3, bw, M, mask, seed=bw * M)
    want = _jax_plain(att_h, att, p_att, am, w, b)
    got = pattn.additive_attention_fused(_t(att_h), _t(att), _t(p_att),
                                         _t(am), _t(w), _t(b))
    assert tuple(got.shape) == (3 * bw, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('bw', [1, 5])
@pytest.mark.parametrize('mask', MASKS)
def test_plain_attention_matches_jax(bw, mask):
    """The port's ``layers.additive_attention`` (h2att and alpha_net as
    nn.Linear) against the JAX one, both branches."""
    att_h, att, p_att, am, w, b = _case(3, bw, 7, mask, seed=bw)
    rng = np.random.RandomState(9)
    h = rng.randn(3 * bw, H).astype('float32')
    k = (rng.randn(H, A) / np.sqrt(H)).astype('float32')
    kb = rng.randn(A).astype('float32') * 0.1
    want = _jax_plain(h @ k + kb, att, p_att, am, w, b)
    h2att = torch.nn.Linear(H, A)
    alpha_net = torch.nn.Linear(A, 1)
    with torch.no_grad():
        h2att.weight.copy_(torch.from_numpy(k.T))
        h2att.bias.copy_(torch.from_numpy(kb))
        alpha_net.weight.copy_(torch.from_numpy(w[None]))
        alpha_net.bias.copy_(torch.from_numpy(b))
        got = players.additive_attention(_t(h), _t(att), _t(p_att), _t(am),
                                         h2att, alpha_net)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_wrapper_rejects_shapes_out_of_range():
    att_h, att, p_att, am, w, b = _case(2, 1, 5, 'ones', seed=0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match='shapes'):
        pattn.additive_attention_fused(t(att_h[:1]), t(att), t(p_att),
                                       t(am), t(w), t(b))
    with pytest.raises(ValueError, match='shapes'):
        pattn.additive_attention_fused(t(att_h), t(att), t(p_att[:, :4]),
                                       t(am), t(w), t(b))
    # the kernel's limits hold for the twin's inputs too: no shape passes
    # on the CPU that the card would refuse
    big = pattn.MAX_BW + 1
    with pytest.raises(ValueError, match='bw=%d' % big):
        pattn.additive_attention_fused(torch.zeros(2 * big, A), t(att),
                                       t(p_att), t(am), t(w), t(b))
    M = pattn.MAX_M + 1
    with pytest.raises(ValueError, match='M=%d' % M):
        pattn.additive_attention_fused(
            torch.zeros(1, 4), torch.zeros(1, M, 4), torch.zeros(1, M, 4),
            torch.ones(1, M), torch.zeros(4), torch.zeros(1))


def test_twin_keeps_float32_features_with_bf16_queries():
    """A bf16 model with use_bn 2 hands the head float32 features: the
    output stays float32 (the JAX kernel's out dtype is att_feats'), and
    only the query side is rounded to bf16."""
    att_h, att, p_att, am, w, b = _case(3, 5, 7, 'ragged', seed=4)
    bf = torch.bfloat16
    got = pattn.additive_attention_fused(_t(att_h).to(bf), _t(att),
                                         _t(p_att).to(bf), _t(am),
                                         _t(w).to(bf), _t(b).to(bf))
    assert got.dtype == torch.float32
    f32 = pattn.additive_attention_fused(_t(att_h), _t(att), _t(p_att),
                                         _t(am), _t(w), _t(b))
    # the scores move by the bf16 rounding of the queries and keys only
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=0.1, rtol=0)
