"""The port imports no JAX: in a fresh interpreter where importing jax,
flax or optax fails, the port's modules import and a tiny CPU beam and
greedy decode run, for the transformer and for UpDown."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import sys
for name in ('jax', 'jaxlib', 'flax', 'optax'):
    sys.modules[name] = None          # any import of them now fails
import importlib
for mod in ('captioning_tpu_torch.models.api',
            'captioning_tpu_torch.engine.decoding',
            'captioning_tpu_torch.utils.eval_utils',
            'captioning_tpu_torch.utils.weights',
            'captioning_tpu_torch.models.harness',
            'captioning_tpu_torch.ops.attention',
            'captioning_tpu_torch.modules.losses',
            'captioning_tpu_torch.ops._build'):
    importlib.import_module(mod)
import torch
from types import SimpleNamespace
from captioning_tpu_torch.models.api import setup
torch.set_num_threads(1)
opt = SimpleNamespace(caption_model='transformer', vocab_size=20,
                      input_encoding_size=16, rnn_size=32, num_layers=2,
                      drop_prob_lm=0.0, fc_feat_size=6, att_feat_size=8,
                      att_hid_size=8, max_length=5, N_enc=1, N_dec=2,
                      d_model=16, d_ff=24, num_att_heads=2)
cap = setup(opt).init_params(torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
fc = torch.randn(3, 6, generator=g)
att = torch.randn(3, 4, 8, generator=g)
am = torch.ones(3, 4)
seq, stats, done = cap.sample_beam(fc, att, am, None, {'beam_size': 3})
assert seq.shape == (3, 5) and done['seq'].shape == (3, 1, 3, 5)
assert torch.isfinite(stats['ent_sum']).all()
seq, stats = cap.sample_stats(fc, att, am, None, {'beam_size': 1})
assert seq.shape == (3, 5) and torch.isfinite(stats['lp_sum']).all()
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax')
       and sys.modules[m] is not None]
assert not bad, bad
assert 'captioning_tpu.models' not in sys.modules
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


def test_rnn_port_runs_without_jax():
    _run(SCRIPT.replace("caption_model='transformer'",
                        "caption_model='updown'"))
