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


# ---------------------------------------------------------------------------
# The CUDA wrapper's launch plan and refusals, on the CPU: the plan is plain
# Python, and a non-CPU tensor (the ``meta`` device stands in for a CUDA
# one) is refused before it could reach the kernel, never handed to the
# twin.
# ---------------------------------------------------------------------------

from captioning_tpu_torch.ops import logit_topk as lt_mod  # noqa: E402

H100_SMS = 132


def _plan_cases():
    for N in (5120, 1024, 1000, 37):
        yield N, lt_mod.bf16_rows(512), lt_mod.BF16_TILE, 1
        yield N, lt_mod.F32_ROWS, lt_mod.F32_TILE, 2
    yield 300, lt_mod.bf16_rows(1024), lt_mod.BF16_TILE, 1


@pytest.mark.parametrize('N,rows,tile,per_sm', list(_plan_cases()))
def test_plan_splits_cover_every_tile_once(N, rows, tile, per_sm):
    V1 = 9488
    splits, per = lt_mod.plan_splits(N, V1, rows, tile, H100_SMS, per_sm)
    tiles = -(-V1 // tile)
    assert per == -(-tiles // splits)          # the kernel's own formula
    seen = [t for s in range(splits)
            for t in range(s * per, min((s + 1) * per, tiles))]
    assert sorted(seen) == list(range(tiles))  # every tile, once
    assert all(s * per < tiles for s in range(splits))   # none empty


@pytest.mark.parametrize('N', [5120, 1024, 37])
def test_plan_splits_fill_the_grid(N):
    """The bf16 plan's span, in tile times (waves x (tiles a split + the x
    load)), is within 15% of the least any split count could give: the
    tiles of all row blocks spread evenly over the SMs.  At the beam and
    greedy steps the grid fills the card; at N 37 (one row block, 149
    tiles) 75 blocks of 2 tiles already give the least span."""
    V1, rows, tile = 9488, lt_mod.bf16_rows(512), lt_mod.BF16_TILE
    splits, per = lt_mod.plan_splits(N, V1, rows, tile, H100_SMS)
    row_blocks, tiles = -(-N // rows), -(-V1 // tile)
    blocks = row_blocks * splits
    span = -(-blocks // H100_SMS) * (per + 1)
    least = -(-row_blocks * tiles // H100_SMS) + 1
    assert span <= 1.15 * least
    if N >= 1024:
        assert 0.9 * H100_SMS <= blocks <= H100_SMS   # one full wave


@pytest.mark.parametrize('D,ptrs,why', [
    (20, (0, 0, 0), 'D % 8'), (1032, (0, 0, 0), 'D <= 1024'),
    (512, (8, 0, 0), '16-byte'), (512, (0, 16 + 2, 0), '16-byte'),
    (512, (0, 0, 2), '4-byte'), (512, (256, 512, 4), None),
    (1024, (0, 0, 0), None)])
def test_bf16_refusal(D, ptrs, why):
    got = lt_mod.bf16_refusal(D, *ptrs)
    assert (got is None) if why is None else (why in got)


def _meta_case(D=64, V1=300, x_offset=0):
    meta = dict(device='meta', dtype=torch.bfloat16)
    flat = torch.empty(9 * D + x_offset, **meta)
    x = flat[x_offset:].view(9, D)
    return x, torch.empty(V1, D, **meta), torch.empty(V1, **meta)


@pytest.mark.parametrize('case,match', [
    (dict(D=20), 'D % 8'), (dict(D=1040), 'D <= 1024'),
    (dict(x_offset=1), '16-byte aligned'), (dict(), 'CUDA')])
def test_wrapper_refuses_before_any_launch(case, match, monkeypatch):
    def twin(*a, **k):
        raise AssertionError('a non-CPU tensor reached the twin')
    monkeypatch.setattr(lt_mod, 'logit_topk_ref', twin)
    x, w, b = _meta_case(**case)
    before = lt_mod.logit_topk.launches
    with pytest.raises(ValueError, match=match):
        lt_mod.logit_topk(x, w, b, k=5)
    assert lt_mod.logit_topk.launches == before
