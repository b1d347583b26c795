"""``captioning_tpu_torch.utils.tracing``: the ring, the window query, the
counters, the profiler switch, and the spans and counters the eval path
and its set-up record (a tiny CPU captioner)."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from captioning_tpu_torch.engine.graphs import EagerRecorder
from captioning_tpu_torch.models.api import setup
from captioning_tpu_torch.ops import _build
from captioning_tpu_torch.utils import eval_utils, tracing
from tests.torch_port_util import inputs, tiny_opt, tiny_rnn_opt, tiny_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_SPANS = ('eval.load', 'eval.h2d', 'eval.decode', 'eval.post')


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _captioner(model='transformer', seed=0):
    opt = tiny_opt() if model == 'transformer' else tiny_rnn_opt(model)
    return setup(opt, tiny_vocab(), 'cpu').init_params(
        torch.Generator().manual_seed(seed))


class _Loader:
    """One split of ``n`` images in batches of ``batch``, no labels: what
    ``eval_split`` reads of a loader."""

    def __init__(self, n, batch, seed=0):
        self.fc, self.att, self.am = inputs(B=n, seed=seed)
        self.n, self.batch, self.pos = n, batch, 0

    def reset_iterator(self, split):
        self.pos = 0

    def get_vocab(self):
        return tiny_vocab()

    def get_batch(self, split):
        a, b = self.pos, min(self.pos + self.batch, self.n)
        self.pos = 0 if b >= self.n else b
        return {'fc_feats': self.fc[a:b], 'att_feats': self.att[a:b],
                'att_masks': self.am[a:b], 'labels': None, 'masks': None,
                'infos': [{'id': i, 'file_path': ''} for i in range(a, b)],
                'bounds': {'it_pos_now': self.pos, 'it_max': self.n,
                           'wrapped': b >= self.n}}


@pytest.mark.parametrize('ring,spans', [(4, 3), (4, 4), (4, 11), (16, 40)])
def test_the_ring_keeps_the_latest_and_counts_all(ring, spans, monkeypatch):
    monkeypatch.setattr(tracing, 'RING', ring)
    for i in range(spans):
        tracing.record('s', float(i), i + 0.5)
    kept = tracing.intervals('s')
    assert kept == [(float(i), i + 0.5)
                    for i in range(max(0, spans - ring), spans)]
    line, = tracing.summary().splitlines()
    assert line.split()[:4] == ['span', 's', 'n', str(spans)]
    assert float(line.split()[5]) == pytest.approx(500.0)


@pytest.mark.parametrize('lo,hi,want', [
    (None, None, [(1.0, 2.0), (2.5, 3.0), (3.0, 5.0), (6.0, 7.0)]),
    (2.5, None, [(2.5, 3.0), (3.0, 5.0), (6.0, 7.0)]),
    (None, 3.0, [(1.0, 2.0), (2.5, 3.0)]),
    (2.0, 5.5, [(2.5, 3.0), (3.0, 5.0)]),
    (1.5, 2.9, []),
])
def test_intervals_inside_a_stretch(lo, hi, want):
    for a, b in [(1.0, 2.0), (2.5, 3.0), (3.0, 5.0), (6.0, 7.0)]:
        tracing.record('s', a, b)
    assert tracing.intervals('s', lo, hi) == want
    assert tracing.intervals('never', lo, hi) == []


def test_counters_add_and_reset():
    tracing.count('a')
    tracing.count('a', 4)
    tracing.count('b', 7)
    got = tracing.counters()
    assert got == {'a': 5, 'b': 7}
    got['a'] = 0                        # a copy
    assert tracing.counters()['a'] == 5
    assert 'count a               5' in tracing.summary()
    tracing.reset()
    assert tracing.counters() == {} and tracing.summary() == ''


@pytest.mark.parametrize('profiled', [False, True])
def test_record_function_only_while_a_profiler_records(profiled,
                                                       monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, 'record_function', Counting)
    monkeypatch.setattr(tracing, '_profiler_enabled', lambda: profiled)
    for _ in range(3):
        with tracing.span('x'):
            pass
    assert entered == (['x'] * 3 if profiled else [])
    assert len(tracing.intervals('x')) == 3


def test_a_span_records_when_its_block_raises():
    with pytest.raises(KeyError):
        with tracing.span('x'):
            raise KeyError('y')
    (a, b), = tracing.intervals('x')
    assert a <= b


def _annotations(prof, tmp_path):
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    out = {}
    for e in events:
        if e.get('cat') == 'user_annotation':
            out[e['name']] = out.get(e['name'], 0) + 1
    return out


# the three decodes of eval_split: beam (the graph entry), greedy stats
# (the graph entry) and diverse groups (the per-step tables)
ROUTES = {'beam': {'beam_size': 3}, 'stats': {'beam_size': 1},
          'slow': {'beam_size': 1, 'group_size': 2}}


@pytest.mark.parametrize('model', ['transformer', 'updown'])
@pytest.mark.parametrize('route', sorted(ROUTES))
def test_eval_split_spans_reach_the_profiler(model, route, tmp_path,
                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    cap = _captioner(model)
    n, batch = 10, 4
    kw = dict(ROUTES[route], num_images=n, split='test', verbose=False,
              suppress_UNK=1, max_length=6, id='tr')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        preds = eval_utils.eval_split(cap, _Loader(n, batch), kw)[1]
    assert len(preds) == n
    got = _annotations(prof, tmp_path)
    batches = -(-n // batch)
    for name in EVAL_SPANS:
        assert got.get(name) == batches, (name, got)
        assert len(tracing.intervals(name)) == batches
    assert got.get('eval.save') == 1 and 'eval.lang' not in got
    # the whole call on the host clock alone: no annotation hides its parts
    assert 'eval.split' not in got
    assert len(tracing.intervals('eval.split')) == 1
    # every array of the batches reached the device: fc, att, masks
    floats = n * (10 + 5 * 12 + 5) * 4
    assert tracing.counters()['eval.h2d_bytes'] == floats


def test_the_spans_nest_inside_the_split(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    eval_utils.eval_split(_captioner(), _Loader(6, 4),
                          dict(beam_size=2, num_images=6, split='test',
                               verbose=False, max_length=6))
    (lo, hi), = tracing.intervals('eval.split')
    inner = [iv for name in EVAL_SPANS + ('eval.save',)
             for iv in tracing.intervals(name)]
    assert len(inner) == 4 * 2 + 1
    assert all(lo <= a <= b <= hi for a, b in inner)
    # the parts never overlap one another
    inner.sort()
    assert all(b <= c for (_, b), (c, _) in zip(inner, inner[1:]))


@pytest.mark.parametrize('model,kind', [('transformer', 'beam'),
                                        ('updown', 'beam'),
                                        ('transformer', 'stats')])
def test_graph_captures_count_one_a_graph_decode(model, kind):
    cap = _captioner(model)
    cap.graph_recorder = EagerRecorder
    entry, opt = ((cap.sample_beam_graphed, {'beam_size': 3}) if kind ==
                  'beam' else (cap.sample_stats_graphed, {}))
    opt = dict(opt, max_length=6, suppress_UNK=1)
    calls = []
    for B in (3, 3, 2):
        fc, att, am = [torch.from_numpy(a) for a in inputs(B=B, seed=B)]
        entry(fc, att, am, None, opt)
        calls.append((tracing.counters().get('graph.captures'),
                      len(tracing.intervals('graph.capture'))))
    assert calls == [(1, 1), (1, 1), (2, 2)]


@pytest.mark.parametrize('how', ['init_params', 'load_jax_variables'])
def test_one_install_a_load(how):
    cap = _captioner('updown')
    tracing.reset()
    if how == 'init_params':
        cap.init_params(torch.Generator().manual_seed(1))
    else:
        cap.load_jax_variables(cap.jax_variables())
    assert len(tracing.intervals('model.install')) == 1


def test_kernels_count_nvcc_runs_and_first_loads(tmp_path, monkeypatch):
    """A library is compiled once (``kernels.nvcc``) and bound once a
    process (``kernels.load``); a found library runs no nvcc."""
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(_build, '_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(_build, '_LIBS', {})

    class Done:
        returncode, stdout, stderr = 0, '', ''

    def run(cmd, **kw):
        open(cmd[cmd.index('-o') + 1], 'w').close()
        return Done()

    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = type('Fn', (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build.subprocess, 'run', run)
    monkeypatch.setattr(_build.ctypes, 'CDLL', Lib)
    _build.load('topk')
    _build.load('topk')
    assert tracing.counters() == {'kernels.nvcc': 1}
    assert len(tracing.intervals('kernels.load')) == 1
    monkeypatch.setattr(_build, '_LIBS', {})
    _build.load('topk')                 # a new process finds the library
    assert tracing.counters() == {'kernels.nvcc': 1}
    assert len(tracing.intervals('kernels.load')) == 2


def test_eval_cli_prints_the_summary(tmp_path, monkeypatch, capsys):
    from captioning_tpu_torch.utils import misc, opts
    from tests.util_synth import build_synthetic_dataset
    ds = build_synthetic_dataset(str(tmp_path / 'synth'))
    opt = opts.parse_opt([
        '--caption_model', 'updown', '--input_json', ds.input_json,
        '--input_label_h5', ds.input_label_h5,
        '--input_fc_dir', ds.input_fc_dir,
        '--input_att_dir', ds.input_att_dir, '--batch_size', '2',
        '--rnn_size', '24', '--input_encoding_size', '16',
        '--att_hid_size', '8', '--fc_feat_size', str(ds.fc_dim),
        '--att_feat_size', str(ds.att_dim), '--max_length', '6',
        '--id', 'tr'])
    with open(ds.input_json) as f:
        vocab = json.load(f)['ix_to_word']
    opt.vocab_size = len(vocab)
    cap = setup(opt, vocab, 'cpu').init_params(
        torch.Generator().manual_seed(0))
    misc.save_pytree(cap.jax_variables(), str(tmp_path / 'model.npz'))
    with open(tmp_path / 'infos_tr.pkl', 'wb') as f:
        misc.pickle_dump({'opt': opt, 'vocab': vocab}, f)
    spec = importlib.util.spec_from_file_location(
        'eval_torch', os.path.join(REPO, 'tools', 'eval_torch.py'))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.chdir(tmp_path)
    tracing.reset()
    cli.main(['--device', 'cpu', '--model', str(tmp_path / 'model.npz'),
              '--infos_path', str(tmp_path / 'infos_tr.pkl'),
              '--split', 'val', '--num_images', '4', '--language_eval', '0',
              '--force', '1', '--beam_size', '2'])
    lines = {ln.split()[1]: ln.split() for ln in
             capsys.readouterr().out.splitlines()
             if ln.startswith(('span ', 'count '))}
    assert lines['eval.split'][3] == '1'
    assert lines['model.install'][3] == '1'
    assert lines['eval.decode'][3] == '2'           # 4 images, batches of 2
    assert int(lines['eval.h2d_bytes'][2]) > 0
    assert np.isfinite(float(lines['eval.post'][5]))
