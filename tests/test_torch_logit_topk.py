"""The port's vocab epilogue (ops/logit_topk.py) against the JAX
``logit_topk_ref``, float32 on the CPU (the wrapper runs its plain twin),
and the port's ``top_k`` helper against ``lax.top_k`` on exact ties.
Indices must be identical; values, row_sum and ent agree within 1e-5 (the
same float32 math up to summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.ops.logit_topk import logit_topk_ref as jax_ref
from captioning_tpu_torch.ops.logit_topk import logit_topk, top_k

D = 24
V1 = 1037        # a multiple of no tile width


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, dup=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(9, D).astype('float32')
    w = (rng.randn(D, V1) * 0.7).astype('float32')      # JAX layout [D, V1]
    b = (rng.randn(V1) * 0.1).astype('float32')
    if dup:
        # duplicated columns: exact ties that must resolve to the lower index
        for lo, hi in ((3, 500), (17, 18), (40, 1036)):
            w[:, hi] = w[:, lo]
            b[hi] = b[lo]
    return x, w, b


@pytest.mark.parametrize('k', [1, 5])
@pytest.mark.parametrize('temp,unk_bias,unk_idx', [
    (1.0, 0.0, -1), (0.7, -1000.0, V1 - 1), (1.3, -1000.0, 5),
    (0.7, 0.0, 5)])
@pytest.mark.parametrize('dup', [False, True])
def test_logit_topk_matches_jax(k, temp, unk_bias, unk_idx, dup):
    x, w, b = _inputs(seed=k, dup=dup)
    got = logit_topk(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                     torch.from_numpy(b), temp, unk_bias, k=k,
                     unk_idx=unk_idx)
    want = jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), temp,
                   unk_bias, k=k, unk_idx=unk_idx)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, e in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-6)


def test_logit_topk_ties_pick_lowest_index():
    x, w, b = _inputs(seed=3, dup=True)
    # make column 17 (and its duplicate 18) everyone's best
    b[17] = b[18] = 50.0
    _, ti, _, _ = logit_topk(torch.from_numpy(x),
                             torch.from_numpy(w.T.copy()),
                             torch.from_numpy(b), k=2)
    assert (ti[:, 0] == 17).all() and (ti[:, 1] == 18).all()


def test_logit_topk_rejects_k_out_of_range():
    x, w, b = _inputs(seed=0)
    with pytest.raises(ValueError):
        logit_topk(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                   torch.from_numpy(b), k=17)


@pytest.mark.parametrize('seed', range(4))
def test_top_k_ties_match_lax_top_k(seed):
    rng = np.random.RandomState(seed)
    # few distinct values -> many exact ties, plus NEG fills and -inf
    x = rng.randint(-3, 3, size=(6, 40)).astype('float32')
    x[0, 5:] = -1e30
    x[1, ::3] = -np.inf
    for k in (1, 5, 12):
        tv, ti = top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
