"""``tools/train_torch.py --mesh_shape data:D,model:M`` on the CPU (gloo
ranks started by the script itself) against one process, the transformer
at tiny widths (1 + 1 layers, d_model 16) on the synthetic dataset with a
vocab of 31 words (V1 = 32, so ``generator`` and ``tgt_embed`` shard 16 +
16 at model 2):

* ``data:1,model:2`` at the transformer's dropout 0.1 (the two ranks of
  the model group must draw one process's masks: they are seeded by the
  data index) and ``data:2,model:2`` at dropout 0 (batch 8: 4 images a
  data index, whose masks another seed draws), one epoch of 2 XE steps
  and a val eval: the loss history and the val loss within rtol 2e-4 /
  atol 2e-5 of one process's (the data axis's CLI bound), the val
  predictions equal, the step route named;
* (g) the ``data:1,model:2`` run's model.npz holds the full arrays, equal
  to one process's at the same iteration within 1e-4 wherever the tensor
  moved from the init by more than rounding (adam moves a tensor whose
  gradient is 0 by the sign of its rounding noise), and
  tools/eval_torch.py decodes it (beam 3) to one process's captions;
* ``--start_from`` resumes the ``data:2,model:2`` run's checkpoint at
  ``data:1,model:2``, its arrays and adam's moments cut into shards, for
  a second epoch whose losses are one process's straight run's (dropout
  0: a resumed run draws its masks anew)."""

import os
import signal

import numpy as np
import pytest

from tests.test_torch_train_cli import _args, _cli, _histories, _load
from tests.util_synth import build_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSFORMER = ['--set_cfgs', 'N_enc', '1', 'N_dec', '1', 'd_model', '16',
               'd_ff', '32', 'num_att_heads', '4']


def _train_args(ds, ckpt, epochs, dropout='0.1', **kw):
    return _args(ds, ckpt, epochs, caption_model='transformer',
                 rnn_size=None, input_encoding_size=None, att_hid_size=None,
                 **kw) + TRANSFORMER + ['dropout', dropout]


def _wait(runs, timeout=300):
    out = []
    try:
        for _, p in runs:
            out.append(p.communicate(timeout=timeout)[0])
    finally:
        for _, p in runs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    for (_, p), log in zip(runs, out):
        assert p.returncode == 0, log[-3000:]
    return out


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """{run: (checkpoint dir, output)}: one process for one epoch (its
    model at each checkpoint kept) and one for two at dropout 0, the two
    meshes for one epoch; then the ``data:2,model:2`` run resumed at
    ``data:1,model:2`` for the second epoch."""
    root = tmp_path_factory.mktemp('model_axis_cli')
    ds = build_synthetic_dataset(str(root / 'data'), vocab_size=31)
    runs = {}
    for name, epochs, extra, kw in (
            ('one', 1, [], dict(save_history_ckpt=1)),
            ('model2', 1, ['--mesh_shape', 'data:1,model:2'], {}),
            ('one_dropout_0', 2, [], dict(dropout='0')),
            ('data2_model2', 1, ['--mesh_shape', 'data:2,model:2'],
             dict(dropout='0'))):
        ckpt = str(root / name / 'ckpt')
        runs[name] = (ckpt, _cli('train_torch.py', _train_args(
            ds, ckpt, epochs, **kw) + extra, str(root / name)))
    logs = dict(zip(runs, _wait(list(runs.values()))))
    ckpt = str(root / 'resumed' / 'ckpt')
    resumed = (ckpt, _cli('train_torch.py', _train_args(
        ds, ckpt, 2, dropout='0', start_from=runs['data2_model2'][0]) +
        ['--mesh_shape', 'data:1,model:2'], str(root / 'resumed')))
    logs['resumed'] = _wait([resumed])[0]
    runs['resumed'] = resumed
    return ds, {name: (runs[name][0], logs[name]) for name in runs}


@pytest.mark.parametrize('run,ranks,one', [
    ('model2', 2, 'one'), ('data2_model2', 4, 'one_dropout_0')])
def test_mesh_run_equals_one_process(cli_runs, run, ranks, one):
    _, runs = cli_runs
    (one, _), (ckpt, log) = runs[one], runs[run]
    assert 'launched %d ranks' % ranks in log
    assert 'distributed: rank %d of %d, backend gloo' % (ranks - 1,
                                                         ranks) in log
    assert 'train step xe: eager (xe_step): model axis (model > 1)' in log
    h1, h2 = _histories(one), _histories(ckpt)
    assert sorted(h2['loss_history']) == [1, 2]
    for it in (1, 2):
        np.testing.assert_allclose(h2['loss_history'][it],
                                   h1['loss_history'][it], rtol=2e-4,
                                   atol=2e-5)
    v1, v2 = h1['val_result_history'][2], h2['val_result_history'][2]
    np.testing.assert_allclose(v2['loss'], v1['loss'], rtol=2e-4, atol=2e-5)
    assert [(p['image_id'], p['caption']) for p in v2['predictions']] == \
        [(p['image_id'], p['caption']) for p in v1['predictions']]
    assert {'model.npz', 'optimizer.npz', 'infos_tr.pkl'} <= \
        set(os.listdir(ckpt))


def test_checkpoint_holds_one_process_arrays(cli_runs):
    from captioning_tpu_torch.utils.misc import _flatten_tree, load_pytree
    _, runs = cli_runs
    one = _flatten_tree(load_pytree(os.path.join(runs['one'][0],
                                                 'model-2.npz')))
    got = _flatten_tree(load_pytree(os.path.join(runs['model2'][0],
                                                 'model.npz')))
    assert sorted(got) == sorted(one)
    assert got['params/generator/kernel'].shape == (16, 32)
    assert got['params/tgt_embed'].shape == (32, 16)
    for key, w in one.items():
        assert got[key].shape == w.shape, key
    close = [k for k in one if np.allclose(got[k], one[k], atol=1e-4,
                                           rtol=0)]
    # the attention's K biases have a gradient that is 0 up to rounding
    assert len(close) >= len(one) - 4, sorted(set(one) - set(close))
    for key in ('params/generator/kernel', 'params/generator/bias',
                'params/tgt_embed'):
        assert key in close


def test_eval_torch_decodes_the_mesh_checkpoint(cli_runs, tmp_path,
                                                monkeypatch):
    import importlib.util
    _, runs = cli_runs
    spec = importlib.util.spec_from_file_location(
        'eval_torch', os.path.join(REPO, 'tools', 'eval_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    captions = []
    for name, model in (('one', 'model-2.npz'), ('model2', 'model.npz')):
        run = tmp_path / name
        run.mkdir()
        monkeypatch.chdir(run)
        ckpt = runs[name][0]
        mod.main(['--device', 'cpu', '--model', os.path.join(ckpt, model),
                  '--infos_path', os.path.join(ckpt, 'infos_tr.pkl'),
                  '--split', 'val', '--num_images', '4', '--language_eval',
                  '0', '--force', '1', '--beam_size', '3', '--max_length',
                  '6', '--id', 'tr'])
        preds = _load(run / 'eval_results' / '.saved_pred_tr_val.pkl')[0]
        captions.append([p['caption'] for p in preds])
    assert len(captions[0]) == 4 and captions[0] == captions[1]


def test_start_from_resumes_into_shards(cli_runs):
    _, runs = cli_runs
    log = runs['resumed'][1]
    assert 'loaded model from' in log
    h1 = _histories(runs['one_dropout_0'][0])
    h2 = _histories(runs['resumed'][0])
    assert sorted(h2['loss_history']) == [1, 2, 3, 4]
    for it in (3, 4):
        np.testing.assert_allclose(h2['loss_history'][it],
                                   h1['loss_history'][it], rtol=2e-4,
                                   atol=2e-5)
    with np.load(os.path.join(runs['resumed'][0], 'optimizer.npz')) as f:
        assert int(f['#1/#0/#0']) == 4
