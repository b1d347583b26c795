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


# --- the kernel's launch plan and limits (pure Python mirrors) -------------

PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize('pair', PAIRS, ids=['f32', 'bf16', 'bf16_f32'])
@pytest.mark.parametrize('M', [1, 36, 1024])
@pytest.mark.parametrize('bw', [1, 5, 8])
def test_launch_plan_covers_every_region_once(pair, M, bw):
    """Phase 1's units tile [0, M) x [0, A) exactly once; each ring stage
    list tiles [0, M) in order; the block's shared memory fits the card's
    227 KB, at the flagship widths and at ragged ones."""
    for H, A in ((1000, 512), (512, 512), (40, 24), (13, 13), (2048, 512)):
        plan = pattn.launch_plan(bw, M, H, A, *pair)
        seen = np.zeros((M, A), int)
        for m, a0, a1 in plan['units']:
            seen[m, a0:a1] += 1
        assert (seen == 1).all()
        assert plan['smem'] <= 232448
        if plan['kernel'] == 'ring':
            assert 2 <= plan['stages'] <= 24
            for key in ('p_stages', 'att_stages'):
                stages = plan[key]
                assert stages[0][0] == 0 and stages[-1][1] == M
                assert all(a[1] == b[0] for a, b in zip(stages, stages[1:]))
                assert all(m0 < m1 for m0, m1 in stages)


def test_launch_plan_takes_the_ring_at_the_flagship_widths():
    for bw in range(1, pattn.MAX_BW + 1):
        for pair in PAIRS:
            assert pattn.launch_plan(bw, 36, 1000, 512,
                                     *pair)['kernel'] == 'ring'
    # rows of no whole 16 bytes, and H past 4 columns a thread: direct
    assert pattn.launch_plan(5, 13, 13, 24, torch.bfloat16,
                             torch.bfloat16)['kernel'] == 'direct'
    assert pattn.launch_plan(5, 13, 24, 13, torch.bfloat16,
                             torch.bfloat16)['kernel'] == 'direct'
    assert pattn.launch_plan(5, 36, 2048, 512, torch.float32,
                             torch.float32)['kernel'] == 'direct'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_shapes_the_old_limit_took_are_still_taken(dtype):
    """The first kernel took any shape whose (bw*A + A + bw*M) floats fit
    48 KiB; every such shape passes the wrapper's check now."""
    for bw in (1, 2, 5, 8):
        for M in (1, 36, 100, 1024):
            for A in (1, 13, 512, 1000, 1024, 4096, 8000):
                if 4 * (bw * A + A + bw * M) > 48 * 1024:
                    continue
                for H in (1, 13, 1000, 4096):
                    assert pattn.smem_bytes(bw, M, A, dtype) <= 232448
                    args = (torch.zeros(bw, A, dtype=dtype),
                            torch.zeros(1, M, H), torch.zeros(1, M, A,
                                                              dtype=dtype),
                            torch.ones(1, M), torch.zeros(A, dtype=dtype),
                            torch.zeros(1, dtype=dtype))
                    assert pattn._check(*args) == (1, bw, M, H, A)


def test_refused_shapes_raise_before_the_twin(monkeypatch):
    """A shape the kernel would refuse raises in the wrapper, before any
    launch and without reaching the plain twin."""
    def twin(*a):
        raise AssertionError('the twin was reached')
    monkeypatch.setattr(pattn, 'additive_attention_ref', twin)
    launches = pattn.additive_attention_fused.launches
    A = 30000                   # queries and w past the 227 KB of a block
    with pytest.raises(ValueError, match='shared memory'):
        pattn.additive_attention_fused(
            torch.zeros(8, A), torch.zeros(1, 4, 4), torch.zeros(1, 4, A),
            torch.ones(1, 4), torch.zeros(A), torch.zeros(1))
    with pytest.raises(ValueError, match='bw=9'):
        pattn.additive_attention_fused(
            torch.zeros(9, 4), torch.zeros(1, 4, 4), torch.zeros(1, 4, 4),
            torch.ones(1, 4), torch.zeros(4), torch.zeros(1))
    assert pattn.additive_attention_fused.launches == launches


def _table_rule(x):
    """The kernel's bf16 tanh rule in plain PyTorch: |x| clamped into the
    table's range, the table filled from torch.tanh, x itself below the
    range and for NaN, the sign of x elsewhere."""
    lo, hi = pattn.TANH_TABLE
    bits = x.view(torch.int16).int() & 0xFFFF
    a = bits & 0x7FFF
    keys = torch.arange(lo, hi, dtype=torch.int32)
    table = torch.tanh(keys.to(torch.int16).view(torch.bfloat16))
    table = table.view(torch.int16).int() & 0xFFFF
    t = table[a.clamp(lo, hi - 1) - lo]
    inside = (a >= lo) & (a <= 0x7F80)
    out = torch.where(inside, t | (bits & 0x8000), bits)
    return out.to(torch.int16).view(torch.bfloat16)


def test_tanh_table_rule_matches_tanh_on_every_bf16_input():
    """The table's bounds (2^-5 <= |x| < 4; below, round(tanh x) = x; at
    and above 4 the clamp's top entry, 3.98, rounds to 1; NaN stays NaN)
    hold for all 65,536 bf16 inputs against torch.tanh here, as
    chip_smoke.py checks the kernel's own rule against tanhf on the card;
    the bounds are the ones the CUDA source states."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(pattn.__file__), '..', 'csrc',
                            'additive_attention.cu')).read()
    lo = int(re.search(r'TAB_LO = (0x[0-9A-F]+)u', src).group(1), 16)
    hi = int(re.search(r'TAB_HI = (0x[0-9A-F]+)u', src).group(1), 16)
    assert (lo, hi) == pattn.TANH_TABLE
    x = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    got, want = _table_rule(x), torch.tanh(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int16)[~nan],
                       want.view(torch.int16)[~nan])
    assert torch.equal(pattn.tanh_table_rule(x).view(torch.int16),
                       want.view(torch.int16))
