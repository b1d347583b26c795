"""The port's ``anc_attend`` (ops/anc_attend.py) against the JAX
``anc_attend_ref`` and the Pallas kernel in interpret mode, on the same
numpy inputs, float32 on the CPU, where the wrapper runs its plain twin.
atol 1e-5 (the same float32 math up to summation order).  Reading layer l
in place equals the twin run on the materialised layer slice."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from captioning_tpu.ops.anc_attend import anc_attend as jax_fused
from captioning_tpu.ops.anc_attend import anc_attend_ref as jax_ref
from captioning_tpu_torch.ops.anc_attend import anc_attend, anc_attend_ref

N, L, H, T, DK, BW = 20, 3, 4, 9, 8, 5   # tests/test_ops.py's shapes


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=7):
    rng = np.random.RandomState(seed)
    K = rng.randn(N, L, H, T, DK).astype('float32')
    V = rng.randn(N, L, H, T, DK).astype('float32')
    q = rng.randn(N, H * DK).astype('float32')
    anc = rng.randint(0, BW, (N, T)).astype('int32')
    return K, V, q, anc


@pytest.mark.parametrize('l', [0, L - 1])
@pytest.mark.parametrize('t', [0, 3, T - 1])
def test_anc_attend_matches_jax(l, t):
    K, V, q, anc = _case()
    tK, tV, tq, tanc = (torch.from_numpy(x) for x in (K, V, q, anc))
    got = anc_attend(tK, tV, tq, tanc, l, t, BW)
    j = [jnp.asarray(x) for x in (K, V, q, anc)]
    want_ref = jax_ref(*j, jnp.int32(l), jnp.int32(t), BW)
    want_pl = jax_fused(*j, jnp.int32(l), jnp.int32(t), BW, interpret=True)
    for want in (want_ref, want_pl):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    # the layer read in place = the twin on the materialised slice
    sliced = anc_attend_ref(tK[:, l:l + 1].clone(), tV[:, l:l + 1].clone(),
                            tq, tanc, 0, t, BW)
    np.testing.assert_array_equal(got.numpy(), sliced.numpy())


@pytest.mark.parametrize('t', [31, 32, 47])
def test_anc_attend_matches_jax_across_the_ancestry_window(t):
    """T 48: steps on both sides of the 32-step window at which the CUDA
    kernel reloads a row's ancestry."""
    rng = np.random.RandomState(t)
    T48 = 48
    K = rng.randn(N, 2, H, T48, DK).astype('float32')
    V = rng.randn(N, 2, H, T48, DK).astype('float32')
    q = rng.randn(N, H * DK).astype('float32')
    anc = rng.randint(0, BW, (N, T48)).astype('int32')
    got = anc_attend(*(torch.from_numpy(x) for x in (K, V, q, anc)), 1, t,
                     BW)
    j = [jnp.asarray(x) for x in (K, V, q, anc)]
    want_ref = jax_ref(*j, jnp.int32(1), jnp.int32(t), BW)
    want_pl = jax_fused(*j, jnp.int32(1), jnp.int32(t), BW, interpret=True)
    for want in (want_ref, want_pl):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_anc_attend_rejects_bad_shapes():
    K, V, q, anc = (torch.from_numpy(x) for x in _case())
    for l, t, bw in ((L, 3, BW), (-1, 3, BW), (0, T, BW), (0, -1, BW),
                     (0, 3, 3)):                       # N % bw
        with pytest.raises(ValueError):
            anc_attend(K, V, q, anc, l, t, bw)
    with pytest.raises(ValueError):
        anc_attend(K, V, q[:, :8], anc, 0, 3, BW)
    with pytest.raises(ValueError):
        anc_attend(K, V[:, :2], q, anc, 0, 3, BW)
    with pytest.raises(ValueError):
        anc_attend(K, V, q, anc[:, :5], 0, 3, BW)
    meta = [torch.empty(x.shape, device='meta', dtype=x.dtype)
            for x in (K, V, q, anc)]
    with pytest.raises(ValueError, match='CUDA'):
        anc_attend(*meta, 0, 3, BW)
    assert anc_attend.launches == 0


def test_bench_anc_attend_runs_on_cpu(capsys):
    """The bench entry point end to end at a tiny size with --device cpu
    (where the wrapper is its twin), with the t sweep at each (T, t) of
    ``SWEEP_T``."""
    from captioning_tpu_torch.tools import bench_anc_attend
    from captioning_tpu_torch.tools.bench_beam_attend import SWEEP_T
    out = bench_anc_attend.main(['20', '9', '1', '--device', 'cpu'])
    assert out['max_err'] == 0 and out['ms'] > 0 and out['plain_ms'] > 0
    assert list(out['sweep']) == ['T %d t %d' % x for x in SWEEP_T]
    assert all(ms > 0 for ms in out['sweep'].values())
    text = capsys.readouterr().out
    assert '6-layer step' in text and 't sweep' in text
