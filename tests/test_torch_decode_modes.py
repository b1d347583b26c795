"""``tools/profile_decode.py``'s decode modes (the ones ``chip_smoke.py``
drives on the card in phases 4-7 and 10) at tiny widths on the CPU: every
mode of every phase-10 model runs through ``Captioner`` and returns the
rows ``MODES`` counts, with finite sums (the constrained general body's
entropy excepted: NaN where a row holds -inf, as in the JAX engine); the
candidate table captured from the constrained general body holds -inf and
the top-k's twin selects from it; one CPU noise handed to two captioners
of the same seed gives the same captions, as phase 10's f32 agreement
hands it to the card and the CPU."""

import importlib.util
import os

import pytest
import torch

from captioning_tpu_torch.ops import topk as tk
from captioning_tpu_torch.tools import bench_topk as bt
from captioning_tpu_torch.tools import profile_decode as pd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(pd, 'V', 40)
    monkeypatch.setattr(pd, 'FEAT', 12)
    monkeypatch.setattr(pd, 'REGIONS', 5)
    monkeypatch.setattr(pd, 'MODELS', {
        'transformer': dict(input_encoding_size=16, rnn_size=32,
                            num_layers=2, drop_prob_lm=0.1, att_hid_size=8,
                            N_enc=1, N_dec=2, d_model=16, d_ff=32,
                            num_att_heads=4),
        'updown': dict(input_encoding_size=24, rnn_size=24, num_layers=2,
                       drop_prob_lm=0.5, att_hid_size=8),
        'newfc': dict(input_encoding_size=16, rnn_size=24, num_layers=1,
                      drop_prob_lm=0.5, att_hid_size=8)})


@pytest.mark.parametrize('model', ['transformer', 'updown', 'newfc'])
def test_phase10_modes_run_on_the_cpu(tiny, model):
    cs = _chip_smoke()
    cap = pd.make_captioner(model, 'float32', 'cpu')
    other = pd.make_captioner(model, 'float32', 'cpu')
    assert len(cap.bad_endings_ix) == (40 - 1) // 4     # 40 is UNK
    B = 3
    fc, att, am = pd.features(B, 'cpu', seed=1)
    for mode, _ in cs.PHASE10[model]:
        rows = B * pd.MODES[mode][2]
        seq, stats = pd.decode(cap, mode, fc, att, am)
        cs.check_output(torch, seq, stats, rows, 20, pd.V,
                        nan_entropy=mode == 'general5')
        draw = cs.cpu_draws(torch, 7)
        s1, _ = pd.decode(cap, mode, fc, att, am, draw)
        s2, _ = pd.decode(other, mode, fc, att, am, draw)
        assert torch.equal(s1, s2), mode
    if model == 'transformer':
        x = bt.capture_table(cap, fc, att, am, mode='general5')
        assert tuple(x.shape) == (B, 5 * (pd.V + 1))
        assert bool(torch.isinf(x).any())
        vals, _ = tk.topk_lastdim(x, 5)
        assert bool(torch.isfinite(vals).all())
