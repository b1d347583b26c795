"""tools/eval_torch.py end to end on the synthetic dataset (--device cpu):
a JAX-initialised tiny transformer or UpDown saved as model.npz + infos
pickle, the port's CLI run on it, and its predictions compared with the
JAX ``eval_split`` on the same checkpoint: identical captions, entropy and
perplexity within 1e-4, the val loss within rtol 1e-5."""

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


def _cli_matches_jax(checkpoint, beam, monkeypatch):
    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.utils import eval_utils

    ds, root, ckpt, cap, variables, opt = checkpoint
    run = root / ('run%d' % beam)
    run.mkdir()
    monkeypatch.chdir(run)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'eval_torch.py'),
         '--device', 'cpu', '--model', str(ckpt / 'model.npz'),
         '--infos_path', str(ckpt / 'infos_tcli.pkl'), '--split', 'val',
         '--num_images', '4', '--language_eval', '0', '--force', '1',
         '--dump_images', '0', '--max_length', '6', '--beam_size',
         str(beam), '--verbose_loss', '1', '--id', 'tcli'],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(run / 'vis' / 'vis.json') as f:
        got = json.load(f)
    with open(run / 'eval_results' / '.saved_pred_tcli_val.pkl', 'rb') as f:
        assert pickle.load(f)[0] == got

    loader = DataLoader(opt)
    kw = {'split': 'val', 'num_images': 4, 'language_eval': 0,
          'verbose': False, 'id': 'tcli_jax', 'max_length': 6,
          'beam_size': beam, 'suppress_UNK': 1, 'verbose_loss': 1}
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
    with pytest.raises(NotImplementedError):
        port_eval.language_eval(ds.annotations, preds, preds, kw, 'val')
