"""The port's ``mha_step_fused`` (ops/mha_step.py) against the JAX
``mha_step_ref`` and the Pallas kernel in interpret mode, on the same numpy
inputs, float32 on the CPU, where the wrapper runs its plain twin.  atol
1e-5 on the output (the same float32 math up to summation order); the
caches are written in place at t and nowhere else, exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from captioning_tpu.ops.mha_step import mha_step_fused as jax_fused
from captioning_tpu.ops.mha_step import mha_step_ref as jax_ref
from captioning_tpu_torch.ops.mha_step import mha_step_fused

N, H, T, DK = 16, 4, 9, 8     # tests/test_ops.py's shapes


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype('float32')
    return mk(N, H, DK), mk(N, H, DK), mk(N, H, DK), mk(N, H, T, DK), mk(
        N, H, T, DK)


@pytest.mark.parametrize('t', [0, 4, T - 1])
def test_mha_step_matches_jax(t):
    q, kn, vn, kc, vc = _case(seed=t)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, k_o, v_o = mha_step_fused(torch.from_numpy(q), torch.from_numpy(kn),
                                   torch.from_numpy(vn), k_t, v_t, t)
    assert k_o is k_t and v_o is v_t          # written in place
    j = [jnp.asarray(x) for x in (q, kn, vn, kc, vc)]
    o1, k1, v1 = jax_ref(*j, t)
    o2, k2, v2 = jax_fused(*j, t, interpret=True)
    for want in (o1, o2):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    for got, jk in ((k_t, (k1, k2)), (v_t, (v1, v2))):
        for want in jk:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the write touched time t only
    kc[:, :, t], vc[:, :, t] = kn, vn
    np.testing.assert_array_equal(k_t.numpy(), kc)
    np.testing.assert_array_equal(v_t.numpy(), vc)


@pytest.mark.parametrize('t', [31, 32, 47])
def test_mha_step_matches_jax_across_the_ancestry_window(t):
    """T 48: steps on both sides of the 32-step window (and the 16-step
    chunks) of the CUDA kernel; the write lands at t only."""
    rng = np.random.RandomState(t)
    T48 = 48
    mk = lambda *s: rng.randn(*s).astype('float32')
    q, kn, vn = mk(N, H, DK), mk(N, H, DK), mk(N, H, DK)
    kc, vc = mk(N, H, T48, DK), mk(N, H, T48, DK)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = mha_step_fused(torch.from_numpy(q), torch.from_numpy(kn),
                         torch.from_numpy(vn), k_t, v_t, t)[0]
    j = [jnp.asarray(x) for x in (q, kn, vn, kc, vc)]
    o1, k1, v1 = jax_ref(*j, t)
    o2 = jax_fused(*j, t, interpret=True)[0]
    for want in (o1, o2):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k1))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v1))


def test_mha_step_rejects_bad_shapes():
    q, kn, vn, kc, vc = (torch.from_numpy(x) for x in _case())
    with pytest.raises(ValueError):
        mha_step_fused(q, kn, vn, kc, vc, T)          # t past the cache
    with pytest.raises(ValueError):
        mha_step_fused(q, kn, vn, kc, vc, -1)
    with pytest.raises(ValueError):
        mha_step_fused(q[:, :2], kn, vn, kc, vc, 0)   # q of other heads
    with pytest.raises(ValueError):
        mha_step_fused(q, kn, vn, kc, vc[:, :, :5], 0)
    meta = [torch.empty(x.shape, device='meta') for x in (q, kn, vn, kc, vc)]
    with pytest.raises(ValueError, match='CUDA'):
        mha_step_fused(*meta, 3)
    assert mha_step_fused.launches == 0
