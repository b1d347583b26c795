"""``tools/eval_torch.py --device_mesh 1`` on the CPU: the launch that a
host with several GPUs takes, forced to 2 gloo rank processes
(``main(argv, n_devices=2)``), against one process of the same command and
against the JAX ``tools/eval.py`` on the same run directory.  A tiny
transformer (N_enc = N_dec = 1, kernels B1 and B2 by their twins), 7 images
of the synthetic dataset made its val split in batches of 5 (each global batch
padded to 6 rows, the pads dropped), beam 3: the captions in order and the
val loss equal; rank 0 alone prints and writes ``vis/vis.json``.
``tools/eval_ensemble_torch.py --device_mesh 1`` (the checkpoint twice,
as the ensemble of ``--ids dm dm``) takes the same launch: 2 ranks equal
one process."""

import json
import os
import pickle
import sys
import types

import numpy as np
import pytest

from tests.torch_port_util import jax_tool_main
from tests.util_synth import build_synthetic_dataset, make_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ['--split', 'val', '--num_images', '7', '--batch_size', '5',
        '--beam_size', '3', '--language_eval', '0', '--force', '1',
        '--dump_images', '0', '--max_length', '6', '--verbose_loss', '1',
        '--id', 'dm']


@pytest.fixture(scope='module')
def run_dir(tmp_path_factory):
    """(root, checkpoint dir) of a JAX-initialised transformer; the root
    holds ``dm.json``, whose val split is the dataset's first 7 images."""
    import jax

    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.models import setup
    from captioning_tpu.utils import misc

    root = tmp_path_factory.mktemp('device_mesh_eval')
    ds = build_synthetic_dataset(str(root / 'synth'))
    opt = make_opt(ds, 'transformer', id='dm', use_pallas=1, N_enc=1,
                   N_dec=1, d_model=16, d_ff=32, num_att_heads=4,
                   max_length=6)
    loader = DataLoader(opt)
    opt.vocab_size = loader.vocab_size
    cap = setup(opt, loader.get_vocab())
    variables = cap.init_params(jax.random.PRNGKey(0), att_len=7)
    ckpt = root / 'ckpt'
    ckpt.mkdir()
    misc.save_pytree(variables, str(ckpt / 'model.npz'))
    with open(ckpt / 'infos_dm.pkl', 'wb') as f:
        misc.pickle_dump({'opt': opt, 'vocab': loader.get_vocab()}, f)
    # the train split is shuffled (by a sampler the prefetch advances):
    # an unshuffled split of 7 images
    with open(ds.input_json) as f:
        info = json.load(f)
    for i, img in enumerate(info['images']):
        img['split'] = 'val' if i < 7 else 'train' if i < 16 else 'test'
    with open(root / 'dm.json', 'w') as f:
        json.dump(info, f)
    return root, ckpt


def _argv(ckpt, *extra):
    return ['--model', str(ckpt / 'model.npz'), '--infos_path',
            str(ckpt / 'infos_dm.pkl'), '--input_json',
            str(ckpt.parent / 'dm.json')] + ARGS + list(extra)


def _ranks(fn):
    """``fn()`` with file descriptor 1 in a temp file, which the rank
    processes print to: (its result, what they printed)."""
    import tempfile
    with tempfile.TemporaryFile('w+') as f:
        fd = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            out = fn()
        finally:
            sys.stdout.flush()
            os.dup2(fd, 1)
            os.close(fd)
        f.seek(0)
        return out, f.read()


def _port_eval(tool, cwd, argv, monkeypatch, capsys, pred_id='dm', **kw):
    """(what it printed, vis.json, the saved predictions) of the port's
    ``tool`` run in-process in ``cwd``."""
    import importlib.util
    cwd.mkdir(exist_ok=True)
    monkeypatch.chdir(cwd)
    spec = importlib.util.spec_from_file_location(
        'port_tool', os.path.join(REPO, 'tools', tool))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(argv, **kw)
    out = capsys.readouterr().out
    with open(cwd / 'vis' / 'vis.json') as f:
        vis = json.load(f)
    with open(cwd / 'eval_results' / ('.saved_pred_%s_val.pkl'
                                      % pred_id), 'rb') as f:
        saved = pickle.load(f)[0]
    return out, vis, saved


def _loss(stdout):
    return float([ln for ln in stdout.splitlines()
                  if ln.startswith('loss: ')][0].split()[-1])


def test_two_ranks_equal_one_process_and_jax(run_dir, monkeypatch, capsys):
    root, ckpt = run_dir
    argv = _argv(ckpt, '--device', 'cpu', '--device_mesh', '1')
    # one process: --device cpu sees no GPU, so --device_mesh 1 changes
    # nothing
    one_out, one, one_saved = _port_eval('eval_torch.py', root / 'one', argv,
                                         monkeypatch, capsys)
    assert 'launched' not in one_out
    (launcher_out, two, _), two_out = _ranks(lambda: _port_eval(
        'eval_torch.py', root / 'two', argv, monkeypatch, capsys,
        n_devices=2))
    assert 'launched 2 ranks' in launcher_out
    assert two_out.count('loss: ') == 1                  # rank 0 only
    assert two_out.count('distributed: rank') == 2

    # the JAX tool on the same run directory
    jax_dir = root / 'jax'
    jax_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    capsys.readouterr()
    jax_tool_main(os.path.join(REPO, 'tools', 'eval.py'), _argv(ckpt),
                  monkeypatch)
    jax_out = capsys.readouterr().out
    with open(jax_dir / 'vis' / 'vis.json') as f:
        want = json.load(f)

    assert len(want) == 7
    for got in (one, two, one_saved):
        assert [(p['image_id'], p['caption']) for p in got] == \
            [(p['image_id'], p['caption']) for p in want]
    for key in ('entropy', 'perplexity'):
        np.testing.assert_allclose([p[key] for p in two],
                                   [p[key] for p in one], atol=1e-5)
    np.testing.assert_allclose(_loss(two_out), _loss(one_out), rtol=1e-5)
    np.testing.assert_allclose(_loss(one_out), _loss(jax_out), rtol=1e-5)


def test_ensemble_two_ranks_equal_one_process(run_dir, monkeypatch,
                                              capsys):
    root, ckpt = run_dir
    ens = root / 'ens'
    for run in ('one', 'two'):
        # the tool reads log_<id>/ in its working directory
        (ens / run / 'log_dm').mkdir(parents=True)
        for name in ('model.npz', 'infos_dm.pkl'):
            os.symlink(ckpt / name, ens / run / 'log_dm' / name)
    # the ensemble tool has no --force and names the run by its ids
    argv = ['--ids', 'dm', 'dm', '--input_json', str(root / 'dm.json'),
            '--device', 'cpu', '--device_mesh', '1'] + [
                a for i, a in enumerate(ARGS)
                if ARGS[i - (i % 2)] not in ('--force', '--id')]
    got = {}
    for name, kw in (('one', {}), ('two', {'n_devices': 2})):
        (out, vis, _), ranks_out = _ranks(lambda: _port_eval(
            'eval_ensemble_torch.py', ens / name, argv, monkeypatch, capsys,
            pred_id='dm1.0+dm1.0', **kw))
        got[name] = vis
        assert ('launched 2 ranks' in out) == bool(kw)
        assert ranks_out.count('distributed: rank') == (2 if kw else 0)
    assert len(got['one']) == 7
    assert [(p['image_id'], p['caption']) for p in got['two']] == \
        [(p['image_id'], p['caption']) for p in got['one']]


def test_eval_ranks_to_start():
    from captioning_tpu_torch.parallel import launch
    opt = types.SimpleNamespace(device_mesh=1, dist_coordinator='',
                                dist_auto=0)
    assert launch.eval_ranks_to_start(opt, 'cpu') == 1
    assert launch.eval_ranks_to_start(opt, 'cpu', 3) == 3
    assert launch.eval_ranks_to_start(opt, 'cuda', 1) == 1
    # a rank of a group, or no --device_mesh: this process evaluates
    for kw in (dict(dist_coordinator='127.0.0.1:1'), dict(dist_auto=1),
               dict(device_mesh=0)):
        assert launch.eval_ranks_to_start(
            types.SimpleNamespace(**dict(vars(opt), **kw)), 'cpu', 4) == 1
