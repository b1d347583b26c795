"""tools/eval_torch.py end to end on the synthetic dataset (--device cpu):
a JAX-initialised tiny transformer, UpDown, StackAtt, NewFC, AdaAttMO,
AoANet, att2in or ShowTell saved as model.npz + infos pickle, the port's
CLI run on it, and its predictions compared with the JAX ``eval_split`` on
the same checkpoint: identical captions, entropy and perplexity within
1e-4, the val loss within rtol 1e-5."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from tests.util_synth import build_synthetic_dataset, make_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checkpoint(tmp_path_factory, model, **kw):
    import jax

    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.models import setup
    from captioning_tpu.utils import misc

    root = tmp_path_factory.mktemp('torch_evalcli_' + model)
    ds = build_synthetic_dataset(str(root / 'synth'))
    opt = make_opt(ds, model, id='tcli', use_pallas=1)
    for k, v in dict(kw, max_length=6).items():
        setattr(opt, k, v)
    loader = DataLoader(opt)
    opt.vocab_size = loader.vocab_size
    cap = setup(opt, loader.get_vocab())
    variables = cap.init_params(jax.random.PRNGKey(0), att_len=7)
    ckpt = root / 'ckpt'
    ckpt.mkdir()
    misc.save_pytree(variables, str(ckpt / 'model.npz'))
    with open(ckpt / 'infos_tcli.pkl', 'wb') as f:
        misc.pickle_dump({'opt': opt, 'vocab': loader.get_vocab()}, f)
    return ds, root, ckpt, cap, variables, opt


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    return _checkpoint(tmp_path_factory, 'transformer', N_enc=2, N_dec=2,
                       d_model=16, d_ff=32, num_att_heads=4)


@pytest.fixture(scope='module')
def updown_checkpoint(tmp_path_factory):
    return _checkpoint(tmp_path_factory, 'updown')


@pytest.mark.parametrize('beam', [1, 3])
def test_eval_cli_matches_jax_eval_split(checkpoint, beam, monkeypatch):
    _cli_matches_jax(checkpoint, beam, monkeypatch)


@pytest.mark.parametrize('beam', [1, 3])
def test_eval_cli_updown_matches_jax_eval_split(updown_checkpoint, beam,
                                                monkeypatch):
    _cli_matches_jax(updown_checkpoint, beam, monkeypatch)


@pytest.fixture(scope='module', params=['stackatt', 'newfc', 'adaattmo'])
def zoo_checkpoint(request, tmp_path_factory):
    kw = {}
    if request.param != 'newfc':
        # opts.if_use_feat loads no fc feature for these, but their fc
        # embed reads one (in the JAX package as in the port)
        kw['use_fc'] = True
    if request.param == 'adaattmo':
        # the sentinel [word embedding width] joins the regions [rnn width]
        kw['input_encoding_size'] = 24
    return _checkpoint(tmp_path_factory, request.param, **kw)


@pytest.mark.parametrize('beam', [1, 3])
def test_eval_cli_rnn_zoo_matches_jax_eval_split(zoo_checkpoint, beam,
                                                 monkeypatch):
    """StackAtt, NewFC and AdaAttMO: the maxout cells, their seeding and
    per-lane feats, through the CLI; the val loss repeats the feats per
    caption where the core reads them per row."""
    _cli_matches_jax(zoo_checkpoint, beam, monkeypatch)


@pytest.fixture(scope='module', params=['aoa', 'att2in', 'show_tell'])
def new_key_checkpoint(request, tmp_path_factory):
    # AoANet at rnn 24 in 4 heads, its 6-layer refiner and AoA decoder
    kw = {'num_heads': 4} if request.param == 'aoa' else {}
    return _checkpoint(tmp_path_factory, request.param, **kw)


@pytest.mark.parametrize('beam', [1, 3])
def test_eval_cli_new_keys_match_jax_eval_split(new_key_checkpoint, beam,
                                                monkeypatch):
    """AoANet (block-shared feats and the mean feats), att2in (the raw
    regions) and ShowTell (its fc seeding): a JAX checkpoint through the
    CLI, the val loss with one feats row per image (AoANet, att2in) or
    per caption."""
    _cli_matches_jax(new_key_checkpoint, beam, monkeypatch)


ROUTES = {
    # the sample family's carried-stats route (top-1 draws nothing)
    'stats-top1': (['--sample_method', 'top1'], {'sample_method': 'top1'}),
    # the per-step tables route: diverse groups, group 0 reported
    'slow-dgreedy': (['--group_size', '2', '--diversity_lambda', '0.5'],
                     {'group_size': 2, 'diversity_lambda': 0.5}),
    # the general beam body with the constraints, and every finished beam
    # printed
    'beam-constraints': (['--decoding_constraint', '1', '--verbose_beam',
                          '1'], {'decoding_constraint': 1,
                                 'verbose_beam': 1}),
}


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_eval_cli_routes_match_jax(checkpoint, route, monkeypatch):
    args, kw = ROUTES[route]
    out = _cli_matches_jax(checkpoint, 3 if 'beam' in route else 1,
                           monkeypatch, args, kw, route)
    if route == 'beam-constraints':
        # 3 finished beams an image, then the separator
        assert out.count('-' * 20) == 4


def _cli_matches_jax(checkpoint, beam, monkeypatch, extra=(), extra_kw=None,
                     tag=''):
    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.utils import eval_utils

    ds, root, ckpt, cap, variables, opt = checkpoint
    run = root / ('run%d%s' % (beam, tag))
    run.mkdir()
    monkeypatch.chdir(run)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'eval_torch.py'),
         '--device', 'cpu', '--model', str(ckpt / 'model.npz'),
         '--infos_path', str(ckpt / 'infos_tcli.pkl'), '--split', 'val',
         '--num_images', '4', '--language_eval', '0', '--force', '1',
         '--dump_images', '0', '--max_length', '6', '--beam_size',
         str(beam), '--verbose_loss', '1', '--id', 'tcli'] + list(extra),
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(run / 'vis' / 'vis.json') as f:
        got = json.load(f)
    with open(run / 'eval_results' / '.saved_pred_tcli_val.pkl', 'rb') as f:
        # as json: a constrained beam's entropy is NaN (here as in JAX)
        assert json.dumps(pickle.load(f)[0]) == json.dumps(got)

    loader = DataLoader(opt)
    kw = {'split': 'val', 'num_images': 4, 'language_eval': 0,
          'verbose': False, 'id': 'tcli_jax', 'max_length': 6,
          'beam_size': beam, 'suppress_UNK': 1, 'verbose_loss': 1}
    kw.update(extra_kw or {})
    jloss, want, _ = eval_utils.eval_split(cap, variables, loader, kw)
    assert [p['image_id'] for p in got] == [p['image_id'] for p in want]
    assert [p['caption'] for p in got] == [p['caption'] for p in want]
    for key in ('entropy', 'perplexity'):
        np.testing.assert_allclose([p[key] for p in got],
                                   [p[key] for p in want], atol=1e-4)
    loss_line = [ln for ln in r.stdout.splitlines()
                 if ln.startswith('loss: ')][0]
    np.testing.assert_allclose(float(loss_line.split()[-1]), jloss,
                               rtol=1e-5)
    return r.stdout


def test_eval_cli_cuda_without_gpu_raises(checkpoint):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    _, _, ckpt, _, _, _ = checkpoint
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'eval_torch.py'),
         '--model', str(ckpt / 'model.npz'),
         '--infos_path', str(ckpt / 'infos_tcli.pkl')],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode != 0
    assert 'no CUDA device' in r.stderr


def test_dump_images_copies_to_vis(checkpoint, tmp_path, monkeypatch):
    """--dump_images copies each source image to vis/imgs/img<n>.jpg, as
    the JAX ``eval_split`` does (the whole last batch, before the trailing
    predictions are dropped); a missing source is skipped silently."""
    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.utils import eval_utils

    ds, _, ckpt, cap, variables, opt = checkpoint
    img_root = tmp_path / 'raw_imgs'
    img_root.mkdir()
    with open(ds.input_json) as f:
        images = json.load(f)['images']
    missing = [img for img in images if img['split'] == 'val'][-1]
    for img in images:
        if img is not missing:
            (img_root / img['file_path']).write_bytes(b'\xff\xd8fakejpg')

    (tmp_path / 'jax').mkdir()
    monkeypatch.chdir(tmp_path / 'jax')
    kw = {'split': 'val', 'num_images': 2, 'language_eval': 0,
          'verbose': False, 'id': 'dmp_jax', 'max_length': 6,
          'beam_size': 1, 'dump_images': 1, 'image_root': str(img_root)}
    eval_utils.eval_split(cap, variables, DataLoader(opt), kw)
    want = sorted(os.listdir('vis/imgs'))
    assert {'img1.jpg', 'img2.jpg'} <= set(want)

    monkeypatch.chdir(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'eval_torch.py'),
         '--device', 'cpu', '--model', str(ckpt / 'model.npz'),
         '--infos_path', str(ckpt / 'infos_tcli.pkl'), '--split', 'val',
         '--num_images', '2', '--language_eval', '0', '--force', '1',
         '--dump_images', '1', '--image_root', str(img_root),
         '--max_length', '6', '--beam_size', '1', '--id', 'dmp'],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert sorted(os.listdir('vis/imgs')) == want
    assert (tmp_path / 'vis' / 'imgs' / 'img1.jpg').read_bytes() == \
        b'\xff\xd8fakejpg'
    assert 'cp "%s' % img_root in r.stdout


def test_language_eval_matches_jax(checkpoint, tmp_path, monkeypatch):
    from captioning_tpu.utils import eval_utils as jax_eval
    from captioning_tpu_torch.utils import eval_utils as port_eval

    ds = checkpoint[0]
    monkeypatch.chdir(tmp_path)
    preds = [{'image_id': 1012, 'caption': 'w1 w2 w3 the',
              'perplexity': 1.0, 'entropy': 2.0},
             {'image_id': 1013, 'caption': 'w4 w5', 'perplexity': 1.5,
              'entropy': 1.0},
             {'image_id': 999, 'caption': 'w6', 'perplexity': 9.0,
              'entropy': 9.0}]        # not in the annotations: filtered
    kw = {'id': 'lv', 'eval_oracle': 0}
    want = jax_eval.language_eval(ds.annotations, preds, [], kw, 'val')
    got = port_eval.language_eval(ds.annotations, preds, [], kw, 'val')
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    assert os.path.isfile('eval_results/lv_val.json')
    # the multi-sample branch: the diversity suite of eval_multi (mutual
    # BLEU, Div-n, self-CIDEr, the oracle scores) over preds_n
    preds_n = [{'image_id': i, 'caption': c} for i, caps in (
        (1012, ('w1 w2 w3', 'w1 w2 w4', 'w5 w6')),
        (1013, ('w4 w5', 'w4 w5 w6 w7', 'w2 w2 w3')))
        for c in caps]
    kw = {'id': 'lvn', 'eval_oracle': 1}
    want = jax_eval.language_eval(ds.annotations, preds, preds_n, kw, 'val')
    got = port_eval.language_eval(ds.annotations, preds, preds_n, kw, 'val')
    assert set(got) == set(want) and 'self_cider' in got and 'Div2' in got
    for key in want:
        if isinstance(want[key], (list, str)) or want[key] is None:
            assert got[key] == want[key], key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                       err_msg=key)
    with open('eval_results/.cache_lvn_val_n.json') as f:
        assert set(json.load(f)) == {'allspice', 'div_stats', 'oracle',
                                     'self_cider'}


@pytest.mark.parametrize('method', ['bs', 'dbs', 'dgreedy', 'top1',
                                    'dbs@0.3', 'dgreedy@0.3'])
def test_eval_split_n_cli_matches_jax(checkpoint, method, monkeypatch):
    """--sample_n 3 through tools/eval_torch.py against the JAX
    ``eval_split``: the multi-sample predictions of ``eval_split_n`` in
    the saved pickle, identical captions for the deterministic methods
    (beams, diverse beams, diverse greedy, top-1 sampling), top-1's
    perplexities within 1e-4; the split's own predictions too.  With
    ``--diversity_lambda`` 0.3 (``<method>@0.3``) the diverse methods
    still decode at the engine's default, as the JAX ``eval_split_n``
    does."""
    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.utils import eval_utils

    ds, root, ckpt, cap, variables, opt = checkpoint
    run = root / ('run_n_' + method)
    run.mkdir()
    monkeypatch.chdir(run)
    method, _, lam = method.partition('@')
    lam_args = ['--diversity_lambda', lam] if lam else []
    beam = 2 if method == 'dbs' else 1
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'eval_torch.py'),
         '--device', 'cpu', '--model', str(ckpt / 'model.npz'),
         '--infos_path', str(ckpt / 'infos_tcli.pkl'), '--split', 'val',
         '--num_images', '4', '--language_eval', '0', '--force', '1',
         '--dump_images', '0', '--max_length', '6', '--beam_size',
         str(beam), '--verbose_loss', '0', '--id', 'tcli',
         '--sample_n', '3', '--sample_n_method', method] + lam_args,
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(run / 'eval_results' / '.saved_pred_tcli_val.pkl', 'rb') as f:
        got, got_n = pickle.load(f)

    kw = {'split': 'val', 'num_images': 4, 'language_eval': 0,
          'verbose': False, 'id': 'tcli_jax', 'max_length': 6,
          'beam_size': beam, 'suppress_UNK': 1, 'verbose_loss': 0,
          'sample_n': 3, 'sample_n_method': method}
    if lam:
        kw['diversity_lambda'] = float(lam)
    _, want, _ = eval_utils.eval_split(cap, variables, DataLoader(opt), kw)
    with open('eval_results/.saved_pred_tcli_jax_val.pkl', 'rb') as f:
        want_n = pickle.load(f)[1]
    assert [p['caption'] for p in got] == [p['caption'] for p in want]
    assert len(got_n) == len(want_n) == 4 * 3
    if method != 'top1':
        assert got_n == want_n
        return
    # sorted by perplexity: compare per (image, caption)
    key = lambda p: (p['image_id'], p['caption'])
    got_n, want_n = sorted(got_n, key=key), sorted(want_n, key=key)
    assert [key(p) for p in got_n] == [key(p) for p in want_n]
    np.testing.assert_allclose([p['perplexity'] for p in got_n],
                               [p['perplexity'] for p in want_n], atol=1e-4)
