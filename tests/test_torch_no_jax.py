"""The port imports no JAX and nothing of the JAX package: in a fresh
interpreter where importing jax, flax, optax or ``captioning_tpu`` fails,
every module of the port (the bench too), ``tools/eval_torch.py`` and
``tools/train_torch.py`` import, and a tiny CPU beam, diverse beam, greedy
and ``sample_n`` top-3 decode, the graph entries' beam and greedy (the
second through a recorder and the graph cache), an XE train step and a
fused SCST step (its reward on ``ops/cider_device.py``) run, for the
transformer and for RNN captioners of each family (UpDown, StackAtt,
NewFC, LM, AdaAttMO).  An AST scan of the port's
sources, ``chip_smoke.py``, ``tools/eval_torch.py`` and
``tools/train_torch.py`` finds no such import either, lazy ones included.
The entry points default to the GPU."""

import ast
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'captioning_tpu_torch')
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'captioning_tpu')

SCRIPT = r'''
import sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'captioning_tpu'):
    sys.modules[name] = None          # any import of them now fails
import importlib, importlib.util, os, pkgutil
import captioning_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    captioning_tpu_torch.__path__, 'captioning_tpu_torch.')]
assert len(mods) > 30, mods
for mod in mods:
    importlib.import_module(mod)
for tool in ('eval_torch', 'train_torch'):
    spec = importlib.util.spec_from_file_location(
        tool, os.path.join('tools', tool + '.py'))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
from types import SimpleNamespace
from captioning_tpu_torch.models.api import setup
torch.set_num_threads(1)
opt = SimpleNamespace(caption_model='transformer', vocab_size=20,
                      input_encoding_size=16, rnn_size=32, num_layers=2,
                      drop_prob_lm=0.0, fc_feat_size=6, att_feat_size=8,
                      att_hid_size=8, max_length=5, N_enc=1, N_dec=2,
                      d_model=16, d_ff=24, num_att_heads=2)
cap = setup(opt, device='cpu').init_params(torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
fc = torch.randn(3, 6, generator=g)
att = torch.randn(3, 4, 8, generator=g)
am = torch.ones(3, 4)
seq, stats, done = cap.sample_beam(fc, att, am, None, {'beam_size': 3})
assert seq.shape == (3, 5) and done['seq'].shape == (3, 1, 3, 5)
assert torch.isfinite(stats['ent_sum']).all()
seq, stats = cap.sample_stats(fc, att, am, None, {'beam_size': 1})
assert seq.shape == (3, 5) and torch.isfinite(stats['lp_sum']).all()
# the graph entries, and through a recorder their cache
gseq, gstats, gdone = cap.sample_beam_graphed(fc, att, am, None,
                                              {'beam_size': 3})
from captioning_tpu_torch.engine.graphs import EagerRecorder
cap.graph_recorder = EagerRecorder
gseq2, _ = cap.sample_stats_graphed(fc, att, am, None, {'beam_size': 1})
assert torch.equal(gseq2, seq) and len(cap._graph_cache) == 1
from captioning_tpu_torch.tools import bench
assert bench.decode_step_flops(opt, 4, 6) > 0
seq, lps, done = cap.sample_beam(fc, att, am, None,
                                 {'beam_size': 4, 'group_size': 2,
                                  'diversity_lambda': 0.5}, want_logps=True)
assert done['seq'].shape == (3, 2, 2, 5) and lps.shape == (3, 5, 21)
seq, lps = cap.sample(fc, att, am, torch.Generator().manual_seed(3),
                      {'sample_method': 'top3', 'sample_n': 2,
                       'beam_size': 1})
assert seq.shape == (6, 5) and lps.shape == (6, 5, 21)
from captioning_tpu_torch.modules.trainer import Trainer
for k, v in dict(optim='adam', learning_rate=1e-3, optim_alpha=0.9,
                 optim_beta=0.999, optim_epsilon=1e-8, weight_decay=0,
                 grad_clip_mode='value', grad_clip_value=0.1).items():
    setattr(opt, k, v)
labels = torch.randint(1, 20, (3, 2, 7), generator=g)
trainer = Trainer(cap, opt)
out = trainer.xe_step(fc, att, labels, torch.ones(3, 2, 7), am, 1e-3, 0.25,
                      torch.Generator().manual_seed(2))
assert torch.isfinite(out['loss'])
from captioning_tpu_torch.ops.cider_device import DeviceCiderD
for k, v in dict(train_sample_n=2, train_sample_method='sample',
                 train_beam_size=1, sc_sample_method='greedy',
                 sc_beam_size=1, cider_reward_weight=1.0).items():
    setattr(opt, k, v)
scorer = DeviceCiderD({(str(i),): 1.0 for i in range(20)}, ref_len=4.0,
                      device='cpu')
out = trainer.sc_fused_step(fc, att, am, labels[:, :, 1:], torch.ones(3, 2),
                            1e-3, None, torch.Generator().manual_seed(4),
                            torch.Generator().manual_seed(5), scorer)
assert torch.isfinite(out['loss']) and torch.isfinite(out['reward'])
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'flax', 'optax', 'captioning_tpu')
       and sys.modules[m] is not None]
assert not bad, bad
print('OK')
'''


def test_port_runs_without_jax():
    _run(SCRIPT)


def _run(script):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    r = subprocess.run([sys.executable, '-c', script], capture_output=True,
                       text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith('OK')


@pytest.mark.parametrize('model', ['updown', 'stackatt', 'newfc',
                                   'language_model', 'adaattmo'])
def test_rnn_port_runs_without_jax(model):
    script = SCRIPT.replace("caption_model='transformer'",
                            "caption_model=%r" % model)
    if model == 'adaattmo':
        # the sentinel joins the regions: word embedding width = rnn width
        script = script.replace('input_encoding_size=16',
                                'input_encoding_size=32')
    _run(script)


def _sources():
    out = [os.path.join(REPO, 'chip_smoke.py'),
           os.path.join(REPO, 'tools', 'eval_torch.py'),
           os.path.join(REPO, 'tools', 'train_torch.py')]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    sources = _sources()
    assert len(sources) > 30
    bad = ['%s: %s' % (os.path.relpath(p, REPO), name)
           for p in sources for name in _imports(p)
           if name.split('.')[0] in BLOCKED]
    assert not bad, bad


def test_entry_points_default_to_the_gpu(monkeypatch):
    """``setup`` and ``Captioner`` ask for CUDA unless told otherwise, and
    raise without a CUDA device rather than carry on on the CPU."""
    from captioning_tpu_torch.models.api import Captioner, setup
    from captioning_tpu_torch.models.config import config_from_opt
    opt = SimpleNamespace(caption_model='transformer', vocab_size=20,
                          input_encoding_size=16, rnn_size=32, num_layers=2,
                          drop_prob_lm=0.0, fc_feat_size=6, att_feat_size=8,
                          att_hid_size=8, max_length=5, N_enc=1, N_dec=2,
                          d_model=16, d_ff=24, num_att_heads=2)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        setup(opt)
    with pytest.raises(RuntimeError, match='CUDA'):
        Captioner(config_from_opt(opt, opt.vocab_size))
    assert setup(opt, device='cpu').device.type == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert setup(opt).device.type == 'cuda'
