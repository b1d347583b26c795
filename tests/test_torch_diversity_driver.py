"""``projects/Diversity/run_diversity_torch.sh``: the Diversity sweeps of
``run_diversity.sh`` and of the ten ``scripts/eval_scripts/*.sh`` through
``tools/eval_torch.py``.

* For every method of ``run_diversity.sh`` and every eval script, with
  ``python`` a stub on PATH that prints its arguments, the driver's
  argument list is the original's with ``tools/eval.py`` swapped for
  ``tools/eval_torch.py --device $DEVICE`` (no decode runs).
* ``--script only_gen_test_n_bs`` runs end to end with ``DEVICE=cpu`` on a
  tiny UpDown run directory of the synthetic dataset: 3 beams an image as
  its samples in the saved predictions."""

import os
import pickle
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, 'projects', 'Diversity', 'run_diversity_torch.sh')
METHODS = [('sp', '0.5'), ('topk', '3'), ('topp', '0.8'), ('dbst', '0.75'),
           ('bs', '1')]
# each eval script's positional arguments, as its command reads them
SCRIPTS = {'bs': ['m1', '0.7', '5'], 'dbst': ['m1', '0.5', '0.7', '5'],
           'sp': ['m1', '0.7', '5', 'pre'],
           'topk': ['m1', '0.7', '3', '5', 'pre'],
           'topp': ['m1', '0.7', '0.9', '5', 'pre']}


@pytest.fixture(scope='module')
def stub(tmp_path_factory):
    """A PATH whose ``python`` prints its arguments, one a line."""
    bin_dir = tmp_path_factory.mktemp('stub_bin')
    path = bin_dir / 'python'
    path.write_text('#!/bin/sh\nprintf \'%s\\n\' "$@"\n')
    path.chmod(0o755)
    return str(bin_dir) + os.pathsep + os.environ['PATH']


def _args(cmd, stub, **env):
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=60, env=dict(os.environ, PATH=stub, **env))
    assert r.returncode == 0, r.stderr
    return r.stdout.splitlines()


def _swapped(want, device):
    assert want[0] == 'tools/eval.py'
    return ['tools/eval_torch.py', '--device', device] + want[1:]


@pytest.mark.parametrize('method,param', METHODS)
def test_driver_runs_run_diversity_sh_flags(stub, method, param):
    args = ['m1', 'test', '5', method, param]
    want = _args(['bash', os.path.join(REPO, 'projects', 'Diversity',
                                       'run_diversity.sh')] + args, stub)
    assert '--sample_n' in want
    assert _args(['bash', DRIVER] + args, stub, DEVICE='cpu') == \
        _swapped(want, 'cpu')
    assert _args(['bash', DRIVER] + args, stub) == _swapped(want, 'cuda')


@pytest.mark.parametrize('kind', ['only_eval', 'only_gen'])
@pytest.mark.parametrize('method', sorted(SCRIPTS))
def test_driver_runs_each_eval_script(stub, kind, method):
    name = '%s_test_n_%s' % (kind, method)
    env = dict(EXTRA_EVAL_ARGS='--max_length 6', IMAGE_ROOT='imgs')
    want = _args(['sh', os.path.join(REPO, 'projects', 'Diversity',
                                     'scripts', 'eval_scripts',
                                     name + '.sh')] + SCRIPTS[method],
                 stub, **env)
    assert want[-2:] == ['--max_length', '6'] and 'imgs' in want
    got = _args(['bash', DRIVER, '--script', name] + SCRIPTS[method], stub,
                DEVICE='cpu', **env)
    assert got == _swapped(want, 'cpu')


def test_driver_refuses_an_unknown_method_or_script(stub):
    r = subprocess.run(['bash', DRIVER, 'm1', 'test', '5', 'nope', '1'],
                       cwd=REPO, capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PATH=stub))
    assert r.returncode != 0 and 'unknown method' in r.stdout
    r = subprocess.run(['bash', DRIVER, '--script', 'nope'], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0


def test_bs_sweep_end_to_end_on_the_cpu(tmp_path):
    import torch

    from captioning_tpu_torch.models.api import setup
    from captioning_tpu_torch.utils import misc
    from tests.util_synth import build_synthetic_dataset, make_opt

    ds = build_synthetic_dataset(str(tmp_path / 'synth'))
    opt = make_opt(ds, 'updown', rnn_size=24, input_encoding_size=16,
                   att_hid_size=8, vocab_size=ds.vocab_size, id='dv')
    cap = setup(opt, None, device='cpu').init_params(
        torch.Generator().manual_seed(0))
    run = tmp_path / 'run'
    (run / 'log_dv').mkdir(parents=True)
    misc.save_pytree(cap.jax_variables(), str(run / 'log_dv' /
                                               'model-best.npz'))
    vocab = {str(i): 'w%d' % i for i in range(1, ds.vocab_size + 1)}
    with open(run / 'log_dv' / 'infos_dv-best.pkl', 'wb') as f:
        misc.pickle_dump({'opt': opt, 'vocab': vocab}, f)
    # the scripts run tools/ from the working directory
    os.symlink(os.path.join(REPO, 'tools'), run / 'tools')
    r = subprocess.run(
        ['bash', DRIVER, '--script', 'only_gen_test_n_bs', 'dv', '1.0', '3'],
        cwd=run, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, DEVICE='cpu', PYTHON=sys.executable,
                 PYTHONPATH=REPO, OMP_NUM_THREADS='1',
                 EXTRA_EVAL_ARGS='--max_length 6'))
    assert r.returncode == 0, r.stderr[-3000:]
    with open(run / 'eval_results' / '.saved_pred_dv_bs_1.0_3_test.pkl',
              'rb') as f:
        predictions, n_predictions = pickle.load(f)
    assert len(predictions) == 4
    assert len(n_predictions) == 4 * 3
    assert {p['image_id'] for p in n_predictions} == \
        {p['image_id'] for p in predictions}
