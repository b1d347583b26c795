"""The port's decoding engine against an independent numpy replica of the
reference algorithms (the oracle of ``tests/test_decoding.py``), on a tiny
markov mock model whose ``init_state`` takes the engine's ``beam=`` hint
(and records it): greedy, beam search with groups, length penalties, the
constraints, top-k sampling, the recompute, diverse sampling and its
trigram block, the carried beam stats against the replayed tables, the
fast body against the general one and the exact early exits.  No JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine import decoding
from captioning_tpu_torch.engine.decoding import DecodeModel


def make_mock_model(V1=11, seq_length=5, seed=0, feat_dim=4, table=None):
    """Logprobs depend on (last token, feats); bad endings 3 and 4, UNK is
    the last id.  ``init_states`` lists every (batch, beam) asked for."""
    rng = np.random.RandomState(seed)
    tbl = rng.randn(V1, V1).astype('float32') * 2.0
    W = rng.randn(feat_dim, V1).astype('float32')
    if table is not None:
        tbl = table
    t_tbl, t_W = torch.from_numpy(tbl), torch.from_numpy(W)
    init_states = []

    def prepare(fc, att, att_masks, rng_):
        return {'f': fc}

    def init_state(batch, beam=False):
        init_states.append((batch, beam))
        return {'t': torch.zeros(batch, dtype=torch.long),
                'prev': torch.zeros(batch, dtype=torch.long)}

    def step(it, feats, state, rng_, logsoftmax=True, uniform_t=False,
             beam_width=0):
        logits = t_tbl[it] + feats['f'] @ t_W
        state = dict(state, t=state['t'] + 1, prev=it)
        if logsoftmax:
            return torch.log_softmax(logits, -1), state
        return logits, state

    dm = DecodeModel(prepare=prepare, init_state=init_state, step=step,
                     seq_length=seq_length, vocab_plus=V1,
                     bad_endings_ix=(3, 4), unk_idx=V1 - 1)
    return dm, tbl, W, init_states


def np_logprobs(table, W, fc, it):
    logits = table[it] + fc @ W
    x = logits - logits.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _reference_beam_search(table, W, fc, beam_size, seq_length, group_size=1,
                           diversity_lambda=0.5, length_penalty=None):
    """Independent numpy replica of the reference batched beam search for
    the mock model (the replica of ``tests/test_decoding.py``)."""
    B, V1 = fc.shape[0], table.shape[0]
    bdash = beam_size // group_size
    length_penalty = length_penalty or (lambda L, p: p)
    init_logprobs = np_logprobs(table, W, fc, np.zeros(B, np.int64))
    beam_seq = [np.zeros((B, bdash, 0), np.int64) for _ in range(group_size)]
    beam_lp_sum = [np.zeros((B, bdash)) for _ in range(group_size)]
    logprobs_tbl = [init_logprobs.copy() for _ in range(group_size)]
    state = [np.zeros((B,), np.int64) for _ in range(group_size)]
    done = [[[] for _ in range(group_size)] for _ in range(B)]
    for t in range(seq_length + group_size - 1):
        for g in range(group_size):
            if not (g <= t <= seq_length + g - 1):
                continue
            lt = t - g
            lp = logprobs_tbl[g].copy()
            if g > 0:
                change = np.zeros((B, V1))
                for pg in range(g):
                    for b in range(B):
                        for k in range(bdash):
                            change[b, beam_seq[pg][b, k, lt]] += 1
                if lt == 0:
                    lp = lp - change * diversity_lambda
                else:
                    lp = lp - np.repeat(change, bdash, 0) * diversity_lambda
            lp3 = lp.reshape(B, -1, V1)
            sums = beam_lp_sum[g][:, :1] if lt == 0 else beam_lp_sum[g]
            flat = (sums[..., None] + lp3).reshape(B, -1)
            ix = np.argsort(-flat, axis=1, kind='stable')[:, :bdash]
            ys = np.take_along_axis(flat, ix, 1)
            beam_ix, sel_ix = ix // V1, ix % V1
            if beam_seq[g].shape[2] > 0:
                hist = np.stack([beam_seq[g][b][beam_ix[b]]
                                 for b in range(B)])
            else:
                hist = np.zeros((B, bdash, 0), np.int64)
            new_seq = np.concatenate([hist, sel_ix[..., None]], axis=2)
            beam_seq[g] = new_seq
            beam_lp_sum[g] = ys
            state[g] = sel_ix.reshape(-1)
            for b in range(B):
                for k in range(bdash):
                    if new_seq[b, k, lt] == 0 or lt == seq_length - 1:
                        done[b][g].append(
                            {'seq': new_seq[b, k].copy(),
                             'p': length_penalty(lt + 1, ys[b, k])})
                        beam_lp_sum[g][b, k] -= 1000.0
            logprobs_tbl[g] = np_logprobs(table, W, np.repeat(fc, bdash, 0),
                                          state[g])
    return [[sorted(done[b][g], key=lambda x: -x['p'])[:bdash]
             for g in range(group_size)] for b in range(B)]


def _fc(B, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(B, 4)
                            .astype('float32'))


def test_greedy_matches_manual_loop():
    dm, table, W, _ = make_mock_model()
    B = 3
    fc = _fc(B, 1)
    seq, lp = decoding.sample(dm, fc, None, None, None,
                              {'sample_method': 'greedy'},
                              return_stats=False)
    seq, lp, fc = seq.numpy(), lp.numpy(), fc.numpy()
    it = np.zeros(B, np.int64)
    unfinished = np.ones(B, bool)
    for t in range(dm.seq_length):
        logprobs = np_logprobs(table, W, fc, it)
        nxt = logprobs.argmax(-1)
        if t == 0:
            unfinished_new = nxt != 0
        else:
            nxt = np.where(unfinished, nxt, 0)
            logprobs = logprobs * unfinished[:, None]
            unfinished_new = unfinished & (nxt != 0)
        assert (seq[:, t] == nxt).all(), t
        np.testing.assert_allclose(lp[:, t], logprobs, atol=1e-5)
        unfinished = unfinished_new
        it = nxt


@pytest.mark.parametrize('beam_size,group_size', [(3, 1), (4, 2), (6, 3)])
def test_beam_search_matches_reference_replica(beam_size, group_size):
    dm, table, W, _ = make_mock_model()
    B = 2
    fc = _fc(B, 2)
    _, _, done = decoding.sample_beam(
        dm, fc, None, None, None,
        {'beam_size': beam_size, 'group_size': group_size, 'sample_n': 1,
         'suppress_UNK': 0}, want_logps=True)
    ref = _reference_beam_search(table, W, fc.numpy(), beam_size,
                                 dm.seq_length, group_size=group_size)
    bdash = beam_size // group_size
    for b in range(B):
        for g in range(group_size):
            for k in range(bdash):
                want = ref[b][g][k]
                got = done['seq'][b, g, k].numpy()[:len(want['seq'])]
                assert (got == want['seq']).all(), (b, g, k)
                assert abs(float(done['p'][b, g, k]) - want['p']) < 1e-4


def test_beam_length_penalty_applied():
    dm, table, W, _ = make_mock_model()
    fc = _fc(2, 3)
    _, _, done = decoding.sample_beam(
        dm, fc, None, None, None,
        {'beam_size': 3, 'sample_n': 1, 'length_penalty': 'avg_1',
         'suppress_UNK': 0})
    ref = _reference_beam_search(table, W, fc.numpy(), 3, dm.seq_length,
                                 length_penalty=lambda L, p: p / max(L, 1))
    for b in range(2):
        assert abs(float(done['p'][b, 0, 0]) - ref[b][0][0]['p']) < 1e-4


def test_decoding_constraint_blocks_repeats():
    dm, _, _, _ = make_mock_model()
    seq, _ = decoding.sample(dm, _fc(3, 4), None, None, None,
                             {'sample_method': 'greedy',
                              'decoding_constraint': 1})
    for row in seq.numpy():
        for a, b in zip(row[:-1], row[1:]):
            if a != 0 or b != 0:
                assert a != b


def test_remove_bad_endings_blocks_eos_after_function_word():
    dm, _, _, _ = make_mock_model()
    seq, lp = decoding.sample(dm, torch.zeros(2, 4), None, None, None,
                              {'sample_method': 'greedy',
                               'remove_bad_endings': 1},
                              return_stats=False)
    seq, lp = seq.numpy(), lp.numpy()
    for b in range(2):
        for t in range(1, dm.seq_length):
            if seq[b, t - 1] in (3, 4):
                # eos cannot follow a bad-ending word: -inf in its table
                assert seq[b, t] != 0 and lp[b, t, 0] == -np.inf


def test_topk_sampling_support():
    dm, table, W, _ = make_mock_model()
    fc = _fc(4, 5)
    seq, _ = decoding.sample(dm, fc, None, None,
                             torch.Generator().manual_seed(1),
                             {'sample_method': 'top2', 'temperature': 1.0})
    seq, fc = seq.numpy(), fc.numpy()
    it = np.zeros(4, np.int64)
    unfinished = np.ones(4, bool)
    for t in range(dm.seq_length):
        top2 = np.argsort(-np_logprobs(table, W, fc, it), 1)[:, :2]
        for b in range(4):
            if unfinished[b]:
                assert seq[b, t] in top2[b]
        unfinished = unfinished & (seq[:, t] != 0)
        it = seq[:, t].copy()
        if not unfinished.any():
            break


def test_scan_logprobs_matches_sample():
    dm, _, _, _ = make_mock_model()
    fc = _fc(3, 6)
    seq, lp = decoding.sample(dm, fc, None, None,
                              torch.Generator().manual_seed(7),
                              {'sample_method': 'sample', 'sample_n': 2},
                              return_stats=False)
    lp2 = decoding.scan_logprobs(dm, fc, None, None, seq, sample_n=2)
    np.testing.assert_allclose(lp.numpy(), lp2.numpy(), atol=1e-5)


def test_diverse_sample_shapes_and_groups_differ():
    dm, _, _, _ = make_mock_model()
    seq, lps = decoding.diverse_sample(
        dm, _fc(2, 8), None, None, None,
        {'sample_method': 'greedy', 'group_size': 3,
         'diversity_lambda': 2.0})
    assert tuple(seq.shape) == (6, dm.seq_length)
    assert tuple(lps.shape) == (6, dm.seq_length)
    seq = seq.numpy().reshape(2, 3, -1)
    assert not (seq[0, 0] == seq[0, 1]).all() or \
        not (seq[0, 0] == seq[0, 2]).all()


@pytest.mark.parametrize('beam_size,group_size,sample_n',
                         [(3, 1, 1), (4, 2, 1), (3, 1, 3)])
def test_beam_carried_stats_match_replay(beam_size, group_size, sample_n):
    """The carried entropy / chosen-logprob sums equal the same reductions
    over the replayed winner distributions."""
    dm, _, _, inits = make_mock_model()
    fc = _fc(2, 4)
    opt = {'beam_size': beam_size, 'group_size': group_size,
           'sample_n': sample_n, 'suppress_UNK': 1}
    seq, logps, _ = decoding.sample_beam(dm, fc, None, None, None, opt,
                                         want_logps=True)
    seq_f, stats, _ = decoding.sample_beam(dm, fc, None, None, None, opt)
    assert (seq == seq_f).all()
    # the beam hint: True for one group; the replay is no beam decode
    assert inits[0] == (2, group_size == 1)
    assert inits[1] == (2 * sample_n, False)
    seq, lp = seq.numpy(), logps.numpy()
    ent = -(np.exp(lp) * lp).sum(-1).sum(1)
    lps = np.take_along_axis(lp, seq[..., None], axis=2)[..., 0].sum(1)
    np.testing.assert_allclose(stats['ent_sum'].numpy(), ent, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(stats['lp_sum'].numpy(), lps, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('suppress,lp', [(0, ''), (1, 'wu_0.9')])
def test_fast_beam_path_equals_general(suppress, lp):
    dm, _, _, _ = make_mock_model()
    fc = _fc(3, 11)
    base = {'beam_size': 4, 'group_size': 1, 'sample_n': 1,
            'suppress_UNK': suppress, 'length_penalty': lp,
            'temperature': 0.9}
    sf, lf, df = decoding.sample_beam(dm, fc, None, None, None, dict(base),
                                      want_logps=True)
    sg, lg, dg = decoding.sample_beam(dm, fc, None, None, None,
                                      dict(base, _beam_general=1),
                                      want_logps=True)
    assert (sf == sg).all() and (df['seq'] == dg['seq']).all()
    for k in ('p', 'unaug_p', 'ent_sum', 'lp_sum'):
        np.testing.assert_allclose(df[k].numpy(), dg[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(lf.numpy(), lg.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('lp', ['', 'wu_0.9', 'avg_0.3'])
def test_beam_early_exit_exact_on_finishing_captions(lp):
    """Every caption ends by step ~3 of 12: the fast body's exit and the
    greedy stats' exit fire, and both still equal the full-length runs."""
    rng = np.random.RandomState(7)
    table = rng.randn(11, 11).astype('float32') * 2.0
    table[1:, 0] += 12.0
    dm, _, _, _ = make_mock_model(seq_length=12, seed=7, table=table)
    calls = []

    def step(*a, **kw):
        calls.append(1)
        return dm.step(*a, **kw)
    dm2 = dataclasses.replace(dm, step=step)
    fc = _fc(4, 3)
    base = {'beam_size': 4, 'group_size': 1, 'sample_n': 1,
            'suppress_UNK': 0, 'length_penalty': lp, 'temperature': 1.0}
    sf, _, df = decoding.sample_beam(dm2, fc, None, None, None, dict(base))
    fast_calls = len(calls)
    sg, _, dg = decoding.sample_beam(dm2, fc, None, None, None,
                                     dict(base, _beam_general=1))
    assert (sf > 0).sum(1).max() <= 4
    if lp != 'avg_0.3':
        assert fast_calls < dm.seq_length
    assert (sf == sg).all() and (df['seq'] == dg['seq']).all()
    for k in ('p', 'unaug_p', 'ent_sum', 'lp_sum'):
        np.testing.assert_allclose(df[k].numpy(), dg[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    seq, lpv = decoding.sample(dm, fc, None, None, None,
                               {'sample_method': 'greedy'},
                               return_stats=False)
    seq2, stats = decoding.sample(dm, fc, None, None, None,
                                  {'sample_method': 'greedy'})
    assert (seq == seq2).all()
    seq, lpv = seq.numpy(), lpv.numpy()
    np.testing.assert_allclose(stats['ent_sum'].numpy(),
                               -(np.exp(lpv) * lpv).sum(-1).sum(1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        stats['lp_sum'].numpy(),
        np.take_along_axis(lpv, seq[..., None], axis=2)[..., 0].sum(1),
        rtol=1e-5, atol=1e-5)


def test_diverse_sample_block_trigrams():
    dm, _, _, _ = make_mock_model(seed=3)
    fc = torch.zeros(2, 4)
    opt = {'sample_method': 'greedy', 'group_size': 2,
           'diversity_lambda': 0.0}
    s_plain, _ = decoding.diverse_sample(dm, fc, None, None, None, opt)
    s_block, _ = decoding.diverse_sample(dm, fc, None, None, None,
                                         dict(opt, block_trigrams=1))

    def n_repeated_trigrams(row):
        tris = [tuple(row[i:i + 3]) for i in range(len(row) - 2)]
        return len(tris) - len(set(tris))
    plain = sum(n_repeated_trigrams(list(r)) for r in s_plain.numpy())
    blocked = sum(n_repeated_trigrams(list(r)) for r in s_block.numpy())
    assert blocked <= plain


def test_sample_return_stats_on_beam_route():
    """sample(return_stats=True) with beam_size > 1 returns the carried
    sums, not the replayed table."""
    dm, _, _, _ = make_mock_model(seed=5)
    fc = _fc(3, 4)
    opt = {'sample_method': 'greedy', 'beam_size': 3, 'group_size': 1,
           'sample_n': 1, 'suppress_UNK': 0}
    seq, stats = decoding.sample(dm, fc, None, None, None, opt)
    assert set(stats) == {'ent_sum', 'lp_sum'}
    assert tuple(stats['ent_sum'].shape) == (3,)
    seq_ref, lp, _ = decoding.sample_beam(dm, fc, None, None, None, opt,
                                          want_logps=True)
    assert (seq == seq_ref).all()
    seq_t, table = decoding.sample(dm, fc, None, None, None, opt,
                                   return_stats=False)
    assert (seq_t == seq_ref).all() and torch.equal(table, lp)
