"""The port's on-device CIDEr-D (``ops/cider_device.py``) against the JAX
package's and against the port's python scorers, on the CPU: the n-gram
hashes bit for bit (tokens near the top of the COCO vocab and of int32
too), the df table, ``sentence_stats``, ``score`` and ``score_grouped``
(CIDEr-D, BLEU-4 and the mixed reward), ``self_critical_reward`` and
``self_cider_grouped`` within 1e-5 of JAX (self-CIDEr with a repeated
sample: of the float64 host scorer), the python ``CiderD`` / ``Bleu`` /
self-CIDEr of ``utils/rewards.py`` within 1e-4, and ``pad_gts``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_synth import build_synthetic_dataset

VOCAB = 26


@pytest.fixture(scope='module')
def ds(tmp_path_factory):
    return build_synthetic_dataset(str(tmp_path_factory.mktemp('tcid')),
                                   vocab_size=VOCAB - 1, seq_length=6)


@pytest.fixture(scope='module')
def scorers(ds):
    from captioning_tpu.ops.cider_device import DeviceCiderD as JaxCiderD
    from captioning_tpu_torch.ops.cider_device import DeviceCiderD
    return (JaxCiderD(ds.cached_tokens),
            DeviceCiderD(ds.cached_tokens, device='cpu'))


def _batch(seed, B, n, L=7, refs=(2, 6)):
    """Candidates [B*n, L] (a 0 somewhere in most rows), a greedy row an
    image, and ragged reference sets of [n_i, 6] ending in 0."""
    rng = np.random.RandomState(seed)
    gen = rng.randint(0, VOCAB, (B * n, L))
    greedy = rng.randint(0, VOCAB, (B, L))
    gts = [rng.randint(1, VOCAB, (rng.randint(*refs), 6)) for _ in range(B)]
    for g in gts:
        g[:, -1] = 0
    return gen, greedy, gts


def _j(x):
    return jnp.asarray(np.asarray(x, np.int32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('seed', [0, 1])
def test_hashes_bit_identical(scorers, seed):
    """Each n-gram position's two hash lanes and its validity equal the JAX
    package's (its uint32 arithmetic), at tokens up to the COCO vocab's
    UNK (9487) and int32's top; the rolled tail too."""
    jsc, psc = scorers
    rng = np.random.RandomState(seed)
    seqs = rng.randint(0, VOCAB, (6, 9))
    seqs[0] = 9487
    seqs[1] = 2 ** 31 - 1 - rng.randint(0, 4, 9)
    seqs[2, 4:] = 0
    seqs[3] = rng.randint(9000, 9488, 9)
    want = jsc._ngram_hashes(_j(seqs))
    got = psc._ngram_hashes(_t(seqs))
    for w, g, name in zip(want, got, ('h1', 'h2', 'valid', 'eff_len')):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype), err_msg=name)
    for lane, key in ((0, 'table_h1'), (1, 'table_h2')):
        np.testing.assert_array_equal(
            getattr(psc, key).numpy(),
            np.asarray(getattr(jsc, key)).astype(np.int64))
    np.testing.assert_array_equal(psc.table_df.numpy(),
                                  np.asarray(jsc.table_df))


def test_sentence_stats_match_jax(scorers):
    jsc, psc = scorers
    gen, _, _ = _batch(2, 3, 4)
    want = jsc.sentence_stats(_j(gen))
    got = psc.sentence_stats(_t(gen))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy().astype(np.float64),
                                   np.asarray(w).astype(np.float64),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_score_matches_jax_and_python_ciderd(ds, scorers):
    """``score`` (references repeated a candidate) against JAX within 1e-5
    and the python CiderD (``utils/cider_scorer.py``) within 1e-4."""
    from captioning_tpu_torch.ops.cider_device import pad_gts
    from captioning_tpu_torch.utils.cider_scorer import CiderD
    from captioning_tpu_torch.utils.rewards import array_to_str
    jsc, psc = scorers
    B, n = 5, 3
    gen, _, gts = _batch(3, B, n)
    refs, mask = pad_gts(gts)
    refs, mask = np.repeat(refs, n, 0), np.repeat(mask, n, 0)
    got = psc.score(_t(gen), _t(refs), _t(mask)).numpy()
    want = np.asarray(jsc.score(_j(gen), _j(refs), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    res = [{'image_id': i, 'caption': [array_to_str(gen[i])]}
           for i in range(B * n)]
    gts_for = {i: [array_to_str(r) for r in gts[i // n]]
               for i in range(B * n)}
    _, py = CiderD(df=ds.cached_tokens).compute_score(gts_for, res)
    np.testing.assert_allclose(got, py, atol=1e-4, rtol=0)


@pytest.mark.parametrize('cider_w,bleu_w', [(1.0, 0.0), (1.0, 0.5),
                                            (0.0, 1.0)],
                         ids=['cider', 'mixed', 'bleu'])
def test_score_grouped_matches_jax_and_python(ds, scorers, cider_w, bleu_w):
    """``score_grouped`` (CIDEr-D, BLEU-4 and the mixed reward) against
    JAX within 1e-5 and ``utils/rewards.get_scores`` (the python CiderD
    and Bleu) within 1e-4."""
    from types import SimpleNamespace

    from captioning_tpu_torch.ops.cider_device import pad_gts
    from captioning_tpu_torch.utils import rewards
    jsc, psc = scorers
    B, n = 4, 3
    gen, _, gts = _batch(4, B, n)
    refs, mask = pad_gts(gts, pad_to_multiple=5)
    got = psc.score_grouped(_t(gen), _t(refs), _t(mask), n, cider_w,
                            bleu_w).numpy()
    want = np.asarray(jsc.score_grouped(_j(gen), _j(refs), jnp.asarray(mask),
                                        n, cider_w, bleu_w))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    rewards.CiderD_scorer = rewards.Cider_scorer = rewards.Bleu_scorer = None
    rewards.init_scorer(ds.cached_tokens)
    py = rewards.get_scores(gts, gen, SimpleNamespace(
        cider_reward_weight=cider_w, bleu_reward_weight=bleu_w))
    np.testing.assert_allclose(got, py, atol=1e-4, rtol=0)


@pytest.mark.parametrize('cider_w,bleu_w', [(1.0, 0.0), (0.5, 1.0)],
                         ids=['cider', 'mixed'])
def test_self_critical_reward_matches_jax_and_python(ds, scorers, cider_w,
                                                     bleu_w):
    from types import SimpleNamespace

    from captioning_tpu_torch.ops.cider_device import pad_gts
    from captioning_tpu_torch.utils import rewards
    jsc, psc = scorers
    B, n = 4, 2
    gen, greedy, gts = _batch(5, B, n)
    refs, mask = pad_gts(gts)
    got = psc.self_critical_reward(_t(greedy), _t(gen), _t(refs), _t(mask),
                                   cider_w, bleu_w).numpy()
    want = np.asarray(jsc.self_critical_reward(
        _j(greedy), _j(gen), _j(refs), jnp.asarray(mask), cider_w, bleu_w))
    assert got.shape == (B * n, gen.shape[1])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    rewards.CiderD_scorer = rewards.Cider_scorer = rewards.Bleu_scorer = None
    rewards.init_scorer(ds.cached_tokens)
    py = rewards.get_self_critical_reward(greedy, gts, gen, SimpleNamespace(
        cider_reward_weight=cider_w, bleu_reward_weight=bleu_w))
    np.testing.assert_allclose(got, py, atol=1e-4, rtol=0)


@pytest.mark.parametrize('n,repeat', [(2, False), (4, False), (4, True),
                                      (5, True)])
def test_self_cider_grouped_matches_jax_and_python(ds, scorers, n, repeat):
    """The self-CIDEr diversity reward against JAX and
    ``utils/rewards.get_self_cider_scores`` (the eigenvalues in float64):
    within 1e-5 of JAX and 1e-4 of the host.  Where an image repeats a
    sample its Gram matrix is singular, and JAX's float32 ``eigvalsh``
    leaves a residue on the zero eigenvalue that the square root lifts to
    2e-5-7e-5 off the host; there the port is held to the host within
    1e-5 and to JAX within 1e-4."""
    from captioning_tpu_torch.utils import rewards
    jsc, psc = scorers
    B = 3
    gen, _, gts = _batch(6, B, n)
    if repeat:
        gen[0] = gen[1]
    got = psc.self_cider_grouped(_t(gen), n).numpy()
    want = np.asarray(jsc.self_cider_grouped(_j(gen), n))
    rewards.CiderD_scorer = rewards.Cider_scorer = rewards.Bleu_scorer = None
    rewards.init_scorer(ds.cached_tokens)
    py = rewards.get_self_cider_scores(gts, gen, None)
    tol_jax, tol_host = (1e-4, 1e-5) if repeat else (1e-5, 1e-4)
    np.testing.assert_allclose(got, want, atol=tol_jax, rtol=0)
    np.testing.assert_allclose(got, py, atol=tol_host, rtol=0)


def test_pad_gts_matches_jax():
    from captioning_tpu.ops.cider_device import pad_gts as jpad
    from captioning_tpu_torch.ops.cider_device import pad_gts
    _, _, gts = _batch(7, 5, 1, refs=(1, 7))
    gts[1] = gts[1][:, :4]
    for multiple in (1, 5):
        for got, want in zip(pad_gts(gts, multiple), jpad(gts, multiple)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
