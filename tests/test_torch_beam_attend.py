"""The port's attend + cache write and its attend alone
(ops/beam_attend.py) against the JAX ``attend_merged_ref`` on the same
numpy inputs, float32 on the CPU, where the wrappers run their plain
twins.  atol 1e-5: both sides are the same float32 math up to summation
order."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from captioning_tpu.ops.beam_attend import attend_merged_ref as jax_ref
from captioning_tpu_torch.ops.beam_attend import (attend_merged,
                                                 attend_write_merged)

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


# ---------------------------------------------------------------------------
# attend_merged: the attend without the write, any T.  The JAX
# ``attend_merged`` itself cannot run on the CPU: it has no interpret switch
# and its BlockSpecs name TPU memory spaces, so the port is held against its
# jnp ``attend_merged_ref`` and against ``_attend_beam`` of the JAX
# transformer on the same values in the head-major layout.
# ---------------------------------------------------------------------------

def _attend_case(T, bw, seed):
    rng = np.random.RandomState(seed)
    N = 3 * bw
    q = rng.randn(N, D).astype('float32')
    k = rng.randn(N, T, D).astype('float32')
    v = rng.randn(N, T, D).astype('float32')
    anc = rng.randint(0, bw, (N, T)).astype('int32')  # any sibling at t0
    return q, k, v, anc


@pytest.mark.parametrize('T', [8, 13, 21, 48])
@pytest.mark.parametrize('bw', [1, 2, 5])
@pytest.mark.parametrize('where', ['first', 'mid', 'last'])
def test_attend_merged_matches_jax(T, bw, where):
    from captioning_tpu.models.transformer import _attend_beam
    t0 = {'first': 0, 'mid': T // 2, 'last': T - 1}[where]
    q, k, v, anc = _attend_case(T, bw, seed=T * 11 + bw)
    t = torch.from_numpy
    kc, vc = t(k.copy()), t(v.copy())
    got = attend_merged(t(q), kc, vc, t(anc) if bw > 1 else None, t0, bw=bw,
                        h=H)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(anc), t0, bw=bw, h=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the same values in the head-major [N, h, T, dk] layout
    N, dk = q.shape[0], D // H
    k_o = k.reshape(N, T, H, dk).transpose(0, 2, 1, 3)
    v_o = v.reshape(N, T, H, dk).transpose(0, 2, 1, 3)
    a = anc if bw > 1 else np.zeros_like(anc)
    tmask = np.broadcast_to(np.arange(T) <= t0, (N, T))
    old = _attend_beam(jnp.asarray(q.reshape(N, H, 1, dk)), jnp.asarray(k_o),
                       jnp.asarray(v_o), jnp.asarray(a), jnp.asarray(tmask),
                       bw, lambda x: x)
    np.testing.assert_allclose(got.numpy(), np.asarray(old).reshape(N, D),
                               atol=1e-5, rtol=0)
    # the attend writes nothing
    np.testing.assert_array_equal(kc.numpy(), k)
    np.testing.assert_array_equal(vc.numpy(), v)


def test_attend_merged_rejects_bad_shapes():
    q, k, v, anc = (torch.from_numpy(x) for x in _attend_case(13, 2, 0))
    for kw in (dict(anc=None, t0=3, bw=2),        # no ancestry at bw 2
               dict(anc=anc, t0=13, bw=2),        # t0 past the cache
               dict(anc=anc, t0=-1, bw=2),
               dict(anc=anc[:, :8], t0=3, bw=2),  # anc of another T
               dict(anc=None, t0=3, bw=4)):       # N % bw
        with pytest.raises(ValueError):
            attend_merged(q, k, v, kw['anc'], kw['t0'], bw=kw['bw'], h=H)
    with pytest.raises(ValueError):
        attend_merged(q, k, v, anc, 3, bw=2, h=5)  # D % h


def test_bench_beam_attend_runs_on_cpu(capsys):
    """The bench entry point end to end at a tiny size with --device cpu
    (where every wrapper is its twin): all four parts run and check, and
    the t sweep times both attends at each (T, t) of ``SWEEP_T``."""
    from captioning_tpu_torch.tools import bench_beam_attend
    out = bench_beam_attend.main(['--device', 'cpu', '--batch', '2', '--dk',
                                  '8', '--iters', '1', '--dtype', 'float32'])
    sweep = out.pop('sweep')
    assert set(out) == {'attend_merged', 'mha_step_fused'}
    assert all(r['max_err'] == 0 and r['ms'] > 0 for r in out.values())
    assert sorted(sweep) == ['attend_merged', 'mha_step_fused']
    keys = ['T %d t %d' % x for x in bench_beam_attend.SWEEP_T]
    for times in sweep.values():
        assert list(times) == keys and all(ms > 0 for ms in times.values())
    text = capsys.readouterr().out
    assert 'in-loop carry' in text and text.count('caches identical') == 9
    assert 't sweep' in text


@pytest.mark.parametrize('dk,size,want', [
    (64, 2, 16), (64, 4, 16), (32, 2, 16), (10, 4, 8), (254, 2, 4),
    (254, 4, 8), (6, 2, 4), (2, 4, 8)])
def test_vector_width_of_the_attend_write_kernel(dk, size, want):
    from captioning_tpu_torch.ops.beam_attend import vector_bytes
    assert vector_bytes(dk * size) == want


def test_a_tensor_off_the_vector_width_is_refused():
    from captioning_tpu_torch.ops import _build
    flat = torch.empty(4 * 64 + 8, device='meta', dtype=torch.bfloat16)
    ok, off = flat[:4 * 64].view(4, 64), flat[4:4 + 4 * 64].view(4, 64)
    _build.check_aligned('attend_write_merged', 16, ok, ok)
    with pytest.raises(ValueError, match='16-byte boundary'):
        _build.check_aligned('attend_write_merged', 16, ok, off)
    _build.check_aligned('attend_write_merged', 4, off)
