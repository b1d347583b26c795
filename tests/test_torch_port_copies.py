"""The port's copies of the JAX package's host-only modules behave as the
originals: the npz tree I/O and the checkpoint writer, the options, the
learning-rate schedules of ``utils/optimizers.py``, the data loader's
batches on the synthetic dataset, the caption metrics through
``language_eval``, the RL rewards of ``utils/rewards.py`` and
``utils/cider_native.py``, the graph cache's key (``freeze_opt``) and the
bench's FLOP model (root ``bench.py``'s ``decode_step_flops``)."""

import json
import os

import numpy as np
import pytest

from tests.util_synth import build_synthetic_dataset, make_opt


@pytest.fixture(scope='module')
def ds(tmp_path_factory):
    return build_synthetic_dataset(str(tmp_path_factory.mktemp('synth')))


def test_pytree_io_matches_jax_package(tmp_path):
    from captioning_tpu.utils import misc as jmisc
    from captioning_tpu_torch.utils import misc as pmisc
    rng = np.random.RandomState(0)
    tree = {'params': {'embed': {'embedding': rng.randn(5, 3)},
                       'layers': [{'w': rng.randn(2, 2)}, None,
                                  {'b': np.arange(4, dtype=np.int32)}]},
            'batch_stats': {'bn': {'mean': rng.randn(3).astype('float32')}}}
    path = str(tmp_path / 'model.npz')
    jmisc.save_pytree(tree, path)
    want, got = jmisc.load_pytree(path), pmisc.load_pytree(path)
    jflat, pflat = jmisc._flatten_tree(want), pmisc._flatten_tree(got)
    assert sorted(jflat) == sorted(pflat) == sorted(
        jmisc._flatten_tree(tree))
    for key, value in jflat.items():
        assert pflat[key].dtype == value.dtype
        np.testing.assert_array_equal(pflat[key], value)
    assert got['params']['layers'][1] is None


def test_checkpoint_writer_matches_jax_package(tmp_path):
    """``save_checkpoint`` of both packages on one numpy tree, optimizer
    state (its empty clip slot leaves no '#0' key) and infos / histories
    writes the same files, npz keys, arrays and pickles."""
    from types import SimpleNamespace

    from captioning_tpu.utils import misc as jmisc
    from captioning_tpu_torch.utils import misc as pmisc
    rng = np.random.RandomState(1)
    params = {'params': {'logit': {'kernel': rng.randn(3, 4)
                                   .astype('float32')}},
              'batch_stats': {'att_bn_in': {'mean': np.zeros(3, 'float32')}}}
    count, mu = np.asarray(3, np.int32), rng.randn(3, 4).astype('float32')
    # the JAX trainer's state: (clip's empty state, (adam's state,)); the
    # port hands the writer the flat tree of the same leaves
    jax_state = ((), ([count, {'logit': {'kernel': mu}}],))
    opt_state = {'#1/#0/#0': count, '#1/#0/#1/logit/kernel': mu}
    infos = {'iter': 3, 'epoch': 1, 'best_val_score': -2.5,
             'loader_state_dict': {'train': {'index': 2}}}
    histories = {'loss_history': {1: 3.0, 2: 2.5}}
    for name, misc in (('jax', jmisc), ('port', pmisc)):
        for append in ('', 'best'):
            misc.save_checkpoint(
                SimpleNamespace(checkpoint_path=str(tmp_path / name),
                                id='x'), params, infos,
                jax_state if name == 'jax' else opt_state, histories,
                append=append)
    files = sorted(os.listdir(tmp_path / 'jax'))
    assert files == sorted(os.listdir(tmp_path / 'port'))
    assert 'optimizer-best.npz' in files and 'histories_x.pkl' in files
    for f in files:
        a, b = tmp_path / 'jax' / f, tmp_path / 'port' / f
        if f.endswith('.npz'):
            jflat, pflat = pmisc.load_flat(str(a)), pmisc.load_flat(str(b))
            assert sorted(jflat) == sorted(pflat), f
            for key in jflat:
                np.testing.assert_array_equal(pflat[key], jflat[key])
        else:
            assert a.read_bytes() == b.read_bytes(), f
    assert sorted(pmisc.load_flat(str(tmp_path / 'jax' / 'optimizer.npz'))
                  ) == sorted(opt_state)


@pytest.mark.parametrize('widths', [
    dict(d_model=512, d_ff=2048, N_dec=6, vocab_size=9487),
    dict(d_model=32, d_ff=48, N_dec=2, vocab_size=20),
    dict(d_model=64, d_ff=100, N_dec=3, vocab_size=1000)])
def test_decode_step_flops_matches_bench_py(widths):
    """The port's bench counts a decode step's FLOPs as the root bench
    does (its MFU numerator), at the headline and other widths and cache
    lengths."""
    from types import SimpleNamespace

    import bench as jax_bench
    from captioning_tpu_torch.tools import bench
    opt = SimpleNamespace(**widths)
    for n_mem, cache_len in ((36, 21), (5, 9), (50, 1)):
        assert bench.decode_step_flops(opt, n_mem, cache_len) == \
            jax_bench.decode_step_flops(opt, n_mem, cache_len)


def test_freeze_opt_matches_jax_package():
    """The graph cache's key from the options, as the JAX ``_jit_cache``
    keys them (dict / list values left out)."""
    from captioning_tpu.models.api import freeze_opt as jax_freeze
    from captioning_tpu_torch.models.api import freeze_opt
    for opt in ({}, {'beam_size': 5, 'suppress_UNK': 1, 'sample_n': 1},
                {'sample_method': 'greedy', 'temperature': 0.7,
                 'length_penalty': 'wu_0.9', 'cfg': {'a': 1},
                 'ids': [1, 2]}):
        assert freeze_opt(opt) == jax_freeze(opt)
        hash(freeze_opt(opt))


def test_lr_schedules_match_jax_package():
    """``noam_rate``, ``epoch_decay_lr`` and ``ReduceLROnPlateau`` (with its
    state dict) against the originals on the same inputs."""
    from types import SimpleNamespace

    from captioning_tpu.utils import optimizers as jopt
    from captioning_tpu_torch.utils import optimizers as popt
    for step in (0, 1, 7, 1999, 2000, 2001, 50000):
        for d, factor, warmup in ((512, 1.0, 2000), (16, 2.0, 20000)):
            assert popt.noam_rate(step, d, factor, warmup) == \
                jopt.noam_rate(step, d, factor, warmup)
    for start, every, rate in ((-1, 3, 0.8), (0, 3, 0.8), (2, 1, 0.5)):
        opt = SimpleNamespace(learning_rate=5e-4, learning_rate_decay_rate=rate,
                              learning_rate_decay_start=start,
                              learning_rate_decay_every=every)
        for epoch in range(12):
            assert popt.epoch_decay_lr(opt, epoch) == \
                jopt.epoch_decay_lr(opt, epoch)
    rng = np.random.RandomState(0)
    vals = list(np.cumsum(rng.randn(40)) * 0.1 + 3.0)
    for mode in ('min', 'max'):
        kw = dict(mode=mode, factor=0.5, patience=2, cooldown=1, min_lr=1e-5)
        want, got = (jopt.ReduceLROnPlateau(4e-4, **kw),
                     popt.ReduceLROnPlateau(4e-4, **kw))
        for i, v in enumerate(vals):
            want.step(v)
            got.step(v)
            assert got.state_dict() == want.state_dict()
            if i == 20:          # resume mid-way from the other's state
                got = popt.ReduceLROnPlateau(1.0, **kw)
                got.load_state_dict(want.state_dict())


def test_opts_match_jax_package(ds):
    import captioning_tpu.utils.opts as jopts
    import captioning_tpu_torch.utils.opts as popts
    args = ['--caption_model', 'updown', '--input_json', ds.input_json,
            '--beam_size', '3', '--set_cfgs', 'd_model', '16']
    assert vars(popts.parse_opt(args)) == vars(jopts.parse_opt(args))


def _same(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], '%s/%s' % (where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, '%s/%d' % (where, i))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), where)
    else:
        assert a == b, where


@pytest.mark.parametrize('model', ['newfc', 'updown'])
def test_data_loader_batches_match_jax_package(ds, model):
    from captioning_tpu.data.dataset import DataLoader as JaxLoader
    from captioning_tpu_torch.data.dataset import DataLoader
    opt = make_opt(ds, model)
    want, got = JaxLoader(opt), DataLoader(opt)
    assert got.vocab_size == want.vocab_size
    assert got.get_vocab() == want.get_vocab()
    for split, n in (('train', 6), ('val', 2), ('test', 2)):
        for i in range(n):
            _same(got.get_batch(split), want.get_batch(split),
                  '%s batch %d' % (split, i))


def test_language_eval_scores_as_jax_coco_eval(tmp_path, monkeypatch):
    from captioning_tpu.utils.coco_eval import evaluate_captions
    from captioning_tpu_torch.utils import eval_utils
    gts = {1: ['a man riding a horse on a beach', 'a person on a horse'],
           2: ['two dogs play in the snow', 'dogs running in snow'],
           3: ['a plate of food with broccoli', 'a dish of vegetables']}
    caps = {1: 'a man on a horse', 2: 'a dog in the snow',
            3: 'a plate of broccoli and food'}
    ann = tmp_path / 'ann.json'
    ann.write_text(json.dumps({'annotations': [
        {'image_id': i, 'caption': c} for i, cs in gts.items() for c in cs]}))
    monkeypatch.chdir(tmp_path)
    preds = [{'image_id': i, 'caption': c, 'perplexity': 2.0 + i,
              'entropy': 1.0} for i, c in caps.items()]
    got = eval_utils.language_eval(str(ann), preds, [], {'id': 'x'}, 'test')
    want, _ = evaluate_captions(gts, {i: [c] for i, c in caps.items()})
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-12), key
    assert 'CIDEr' in want and 'Bleu_4' in want
    assert got['perplexity'] == pytest.approx(4.0)
    assert os.path.isfile(tmp_path / 'eval_results' / 'x_test.json')


def _same_tree(got, want, key=''):
    """Equal nested results: numbers within 1e-12, NaN where NaN."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _same_tree(got[k], want[k], '%s/%s' % (key, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, '%s/%d' % (key, i))
    elif isinstance(want, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=key)
    else:
        assert got == want, key


def test_diversity_suite_matches_jax_package(tmp_path, monkeypatch):
    """``utils/eval_multi.py`` and ``utils/div_utils.py``, the port's
    copies, score multi-sample predictions as the originals do: Div-n and
    its pooled form, mutual BLEU, the oracle / average best-of-n and
    self-CIDEr (AllSPICE is gated on the SPICE jar in both)."""
    from captioning_tpu.utils import div_utils as jdiv
    from captioning_tpu.utils import eval_multi as jmulti
    from captioning_tpu_torch.utils import div_utils as pdiv
    from captioning_tpu_torch.utils import eval_multi as pmulti
    gts = {1: ['a man riding a horse on a beach', 'a person on a horse'],
           2: ['two dogs play in the snow', 'dogs running in snow']}
    ann = tmp_path / 'ann.json'
    ann.write_text(json.dumps({'annotations': [
        {'image_id': i, 'caption': c} for i, cs in gts.items() for c in cs]}))
    monkeypatch.chdir(tmp_path)
    preds_n = [{'image_id': i, 'caption': c} for i, caps in (
        (1, ('a man on a horse', 'a man riding a horse', 'a horse')),
        (2, ('dogs in the snow', 'two dogs in snow', 'a dog plays')))
        for c in caps]
    for name in ('eval_div_stats', 'eval_oracle', 'eval_self_cider',
                 'eval_allspice'):
        want = getattr(jmulti, name)(str(ann), preds_n, 'm', 'test')
        got = getattr(pmulti, name)(str(ann), preds_n, 'm', 'test')
        _same_tree(got, want, name)
    caps = {1: ['a b c a', 'a b'], 2: ['c d', 'c d e f', 'e']}
    for n in (1, 2, 3):
        for fn in ('compute_div_n', 'compute_global_div_n'):
            _same_tree(getattr(pdiv, fn)(caps, n), getattr(jdiv, fn)(caps, n),
                       '%s %d' % (fn, n))


def test_bad_endings_match_jax_package():
    """The words ``remove_bad_endings`` bans before EOS, and the ids that
    ``Captioner`` takes from a vocab, as the JAX package's."""
    from captioning_tpu.models import api as japi
    from captioning_tpu.models import harness as jharness
    from captioning_tpu_torch.models import api as papi
    from captioning_tpu_torch.models import harness as pharness
    assert pharness.BAD_ENDINGS == jharness.BAD_ENDINGS
    vocab = {str(i): w for i, w in enumerate(
        ['x', 'a', 'dog', 'the', 'on', 'of', 'this', 'that', 'UNK'], 1)}
    for v in (vocab, None):
        assert papi._vocab_indices(v, 9) == japi._vocab_indices(v, 9)


@pytest.mark.parametrize('cider_w,bleu_w', [(1.0, 0.0), (0.5, 1.0)],
                         ids=['cider', 'mixed'])
def test_rewards_match_jax_package(ds, cider_w, bleu_w):
    """``utils/rewards.py``, the port's copy: the self-critical reward, the
    structure scores and the self-CIDEr scores of the same sequences equal
    the original's."""
    from types import SimpleNamespace

    from captioning_tpu.utils import rewards as jrewards
    from captioning_tpu_torch.utils import rewards as prewards
    rng = np.random.RandomState(0)
    B, n = 3, 3
    gen = rng.randint(0, ds.vocab_size + 1, (B * n, 7))
    greedy = rng.randint(0, ds.vocab_size + 1, (B, 7))
    gts = [rng.randint(1, ds.vocab_size + 1, (rng.randint(2, 5), 6))
           for _ in range(B)]
    opt = SimpleNamespace(cider_reward_weight=cider_w,
                          bleu_reward_weight=bleu_w)
    for mod in (jrewards, prewards):
        mod.CiderD_scorer = mod.Cider_scorer = mod.Bleu_scorer = None
        mod.init_scorer(ds.cached_tokens)
    assert prewards.array_to_str(gen[0]) == jrewards.array_to_str(gen[0])
    for name, args in (('get_self_critical_reward', (greedy, gts, gen, opt)),
                       ('get_scores', (gts, gen, opt)),
                       ('get_self_cider_scores', (gts, gen, opt))):
        want = getattr(jrewards, name)(*args)
        got = getattr(prewards, name)(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    for mod in (jrewards, prewards):
        mod.CiderD_scorer = mod.Cider_scorer = mod.Bleu_scorer = None


def test_native_scorer_matches_jax_package(ds):
    """``utils/cider_native.py``, the port's copy, built from the shared
    ``native/cider_d.cpp``: the structure scores and the self-critical
    reward equal the original's, and the python CiderD's within 1e-4."""
    from types import SimpleNamespace

    from captioning_tpu.utils import cider_native as jnative
    from captioning_tpu_torch.utils import cider_native as pnative
    from captioning_tpu_torch.utils import rewards
    rng = np.random.RandomState(1)
    B, n = 4, 2
    gen = rng.randint(0, ds.vocab_size + 1, (B * n, 7))
    greedy = rng.randint(0, ds.vocab_size + 1, (B, 7))
    gts = [rng.randint(1, ds.vocab_size + 1, (rng.randint(2, 5), 6))
           for _ in range(B)]
    jsc = jnative.NativeCiderD(ds.cached_tokens)
    psc = pnative.NativeCiderD(ds.cached_tokens)
    np.testing.assert_array_equal(
        pnative.native_get_scores(psc, gts, gen, 0.5),
        jnative.native_get_scores(jsc, gts, gen, 0.5))
    got = pnative.native_self_critical_reward(psc, greedy, gts, gen)
    np.testing.assert_array_equal(
        got, jnative.native_self_critical_reward(jsc, greedy, gts, gen))
    rewards.CiderD_scorer = None
    rewards.init_scorer(ds.cached_tokens)
    py = rewards.get_self_critical_reward(greedy, gts, gen, SimpleNamespace(
        cider_reward_weight=1.0, bleu_reward_weight=0.0))
    rewards.CiderD_scorer = rewards.Cider_scorer = rewards.Bleu_scorer = None
    np.testing.assert_allclose(got, py, atol=1e-4, rtol=0)
