"""The port's attend + cache write (ops/beam_attend.py) against the JAX
``attend_merged_ref`` on the same numpy inputs, float32 on the CPU, where
the wrapper runs its plain twin.  atol 1e-5: both sides are the same
float32 math up to summation order."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from captioning_tpu.ops.beam_attend import attend_merged_ref as jax_ref
from captioning_tpu_torch.ops.beam_attend import attend_write_merged

H = 4
D = 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(Tp, bw, t0, seed):
    rng = np.random.RandomState(seed)
    N = 3 * bw
    q = rng.randn(N, D).astype('float32')
    k = rng.randn(N, Tp, D).astype('float32')
    v = rng.randn(N, Tp, D).astype('float32')
    kn = rng.randn(N, D).astype('float32')
    vn = rng.randn(N, D).astype('float32')
    anc = rng.randint(0, bw, (N, Tp)).astype('int32')
    anc[:, t0] = np.arange(N) % bw          # the step's own slot
    return q, k, v, kn, vn, anc


@pytest.mark.parametrize('Tp', [8, 24, 32, 48])
@pytest.mark.parametrize('bw', [1, 2, 5])
@pytest.mark.parametrize('where', ['first', 'mid', 'last'])
def test_attend_write_matches_jax(Tp, bw, where):
    t0 = {'first': 0, 'mid': Tp // 2, 'last': Tp - 1}[where]
    q, k, v, kn, vn, anc = _case(Tp, bw, t0, seed=Tp * 7 + bw)
    kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ctx = attend_write_merged(
        torch.from_numpy(q), kc, vc, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(anc) if bw > 1 else None, t0,
        bw=bw, h=H)
    # the JAX side writes the entry functionally, then attends
    k[:, t0], v[:, t0] = kn, vn
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(anc), t0, bw=bw, h=H)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the caches were written in place at row t0 and nowhere else
    np.testing.assert_array_equal(kc.numpy(), k)
    np.testing.assert_array_equal(vc.numpy(), v)


def test_attend_write_rejects_bad_shapes():
    q, k, v, kn, vn, anc = _case(8, 2, 3, seed=0)
    t = torch.from_numpy
    with pytest.raises(ValueError):
        attend_write_merged(t(q), t(k), t(v), t(kn), t(vn), None, 3, bw=2,
                            h=H)
    with pytest.raises(ValueError):
        attend_write_merged(t(q), t(k), t(v), t(kn), t(vn), t(anc), 8, bw=2,
                            h=H)
