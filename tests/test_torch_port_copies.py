"""The port's copies of the JAX package's host-only modules behave as the
originals: the npz tree I/O, the options, the data loader's batches on the
synthetic dataset, and the caption metrics through ``language_eval``."""

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
