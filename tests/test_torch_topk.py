"""The port's exact top-k (``ops/topk.py``) against the JAX package, float32
on the CPU, where the wrapper runs its twin (a stable descending sort):
against ``topk_lastdim`` in interpret mode and against ``lax.top_k``, on
rows full of exact ties, all--inf and all-NEG rows, NEG-masked beam lanes,
ascending and descending rows, plateaus whose k-th entry is a tie, and row
widths no multiple of the Pallas block (the row kinds the kernel is
checked on on the card).  Values and indices must be identical.  The plain beam route selects through it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.ops.topk import topk_lastdim as jax_topk
from captioning_tpu_torch.engine import decoding
from captioning_tpu_torch.ops import topk as ptopk
from tests.torch_port_util import inputs, jax_and_port, tiny_rnn_opt

NEG = -1e30


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(kind, B, C, seed, k=1):
    rng = np.random.RandomState(seed)
    if kind == 'random':
        x = rng.randn(B, C).astype('float32')
    elif kind == 'ties':
        # integer values in [-3, 3]: every value repeats hundreds of times
        x = rng.randint(-3, 4, (B, C)).astype('float32')
    elif kind == 'lanes':
        # the beam's bos step: lane 0 holds the log-probs, lanes 1.. are
        # NEG + log-prob, which rounds to NEG: long runs of exact ties
        V1 = C // 5
        lp = np.log(rng.dirichlet(np.ones(V1), B)).astype('float32')
        x = np.concatenate([lp] + [lp + np.float32(NEG)] * 4, 1)
        x = np.pad(x, ((0, 0), (0, C - x.shape[1])),
                   constant_values=np.float32(NEG))
    elif kind in ('ascending', 'descending'):
        x = np.sort(rng.randn(B, C), 1)
        if kind == 'descending':
            x = x[:, ::-1]
    elif kind == 'plateau':
        # all equal but k - 1 larger values: the k-th entry is a tie that
        # resolves to the lowest index
        x = np.full((B, C), 0.5)
        for r in range(B):
            x[r, rng.choice(C, k - 1, replace=False)] = 2.0
    else:
        x = rng.randn(B, C).astype('float32')
        x[0] = -np.inf
        x[1] = NEG
        x[2, ::3] = -np.inf
        x[3, :] = 2.5
    return x.astype('float32')


@pytest.mark.parametrize('kind', ['random', 'ties', 'lanes', 'special',
                                  'ascending', 'descending', 'plateau'])
@pytest.mark.parametrize('C', [300, 1037])
@pytest.mark.parametrize('k', [1, 2, 3, 5, 8, 16])
def test_twin_matches_pallas_interpret_and_lax_top_k(kind, C, k):
    x = _rows(kind, 6, C, seed=C + k, k=k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    pl_v, pl_i = jax_topk(jnp.asarray(x), k, 256, 256, True)
    launches = ptopk.topk_lastdim.launches
    got_v, got_i = ptopk.topk_lastdim(torch.from_numpy(x), k)
    assert ptopk.topk_lastdim.launches == launches           # CPU: the twin
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int64
    for want in ((want_v, want_i), (pl_v, pl_i)):
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want[1]))


def test_casts_to_float32_like_the_jax_wrapper():
    x = _rows('ties', 3, 50, seed=0)
    got_v, got_i = ptopk.topk_lastdim(torch.from_numpy(x).double(), 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    assert got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, 20)
    for k in (0, 17):
        with pytest.raises(ValueError, match='k <='):
            ptopk.topk_lastdim(x, k)
    with pytest.raises(ValueError, match='k <='):
        ptopk.topk_lastdim(x[:, :3], 5)
    with pytest.raises(ValueError, match='contiguous'):
        ptopk.topk_lastdim(x.t(), 2)


@pytest.mark.parametrize('model', ['updown', 'stackatt', 'newfc'])
def test_plain_beam_route_selects_through_topk_lastdim(model, monkeypatch):
    """Every step of the plain beam route takes its [B, bdash*V1] selection
    from ``topk_lastdim``; the tokens stay those of the JAX package."""
    jcap, variables, pcap = jax_and_port(seed=3, opt=tiny_rnn_opt(model))
    fc, att, am = inputs(B=3, seed=5)
    opt = {'beam_size': 5, 'sample_n': 1, 'group_size': 1}
    calls = []

    def counting(x, k):
        calls.append(tuple(x.shape))
        return ptopk.topk_lastdim(x, k)
    monkeypatch.setattr(decoding, 'topk_lastdim', counting)
    dm = pcap.bind()
    steps = []

    def step(*a, **kw):
        steps.append(1)
        return dm.step(*a, **kw)
    with torch.inference_mode():
        seq, _, _ = decoding.sample_beam(
            dataclasses.replace(dm, step=step),
            *(torch.from_numpy(a) for a in (fc, att, am)), None, opt)
    js, _, _ = jcap.sample_beam_jit(
        variables, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(am),
        jax.random.PRNGKey(1), opt, want_logps=False)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    # one selection per loop step: after the bos step and after each
    # beam step
    assert len(calls) == len(steps)
    assert set(calls) == {(3, 5 * 30)}


def test_bench_rows_and_captured_table():
    """``tools/bench_topk.py``, which feeds the kernel's checks on the card:
    its row kinds have the stated shape and order, and the table it
    captures is the one the plain beam route selects from, with the route's
    own ``topk_lastdim`` put back afterwards."""
    from captioning_tpu_torch.tools import bench_topk as bt
    for kind in bt.KINDS:
        x = bt.rows(3, 40, kind, 5, seed=1, device='cpu')
        assert x.shape == (3, 40) and x.dtype == torch.float32
        assert x.is_contiguous()
    asc = bt.rows(3, 40, 'ascending', 5, seed=1, device='cpu')
    assert bool((asc.diff(dim=1) >= 0).all())
    plateau = bt.rows(3, 40, 'plateau', 5, seed=1, device='cpu')
    v, i = ptopk.top_k(plateau, 5)
    assert bool((v[:, :4] == 2.0).all()) and bool((v[:, 4] == 0.5).all())
    first_low = (plateau == 0.5).int().argmax(1)     # lowest plateau column
    np.testing.assert_array_equal(i[:, 4].numpy(), first_low.numpy())

    _, _, pcap = jax_and_port(seed=3, opt=tiny_rnn_opt('updown'))
    fc, att, am = (torch.from_numpy(a) for a in inputs(B=3, seed=5))
    real = decoding.topk_lastdim
    with torch.inference_mode():
        table = bt.capture_table(pcap, fc, att, am, step=2)
    assert decoding.topk_lastdim is real
    assert table.shape == (3, 5 * 30) and table.dtype == torch.float32
    bt.check(ptopk, table, 5, 'captured')
