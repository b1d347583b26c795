"""``utils.tracing.device_span`` and the spans a graph decode records:
``decode.setup`` (the setup graph's replay), ``decode.step`` (a step
graph's replay) and the counter ``decode.steps``.

On the CPU: the host fallback, ``resolve`` over stand-in events (it keeps
what has ended, oldest first, stops at the first still running and pools
the events), and a ``GraphDecode`` built by ``EagerRecorder``.  Marked
``chip`` (each skips without a CUDA device): on the card the spans equal
their events' elapsed times, a call adds no synchronize, and the tokens
are the eager decode's.  On the card, from the repo root (the suite's
conftest needs JAX, which the card's machine does not have)::

    python -m pytest --noconftest -q -m chip tests/test_torch_device_spans.py
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from captioning_tpu_torch.engine.graphs import EagerRecorder  # noqa: E402
from captioning_tpu_torch.models.api import setup  # noqa: E402
from captioning_tpu_torch.utils import tracing  # noqa: E402

BEAM = {'beam_size': 3, 'max_length': 6, 'suppress_UNK': 1}
# AoANet at tiny widths (the card's machine may hold another top-level
# ``tests`` package, so nothing is imported from this one): rnn 32 in 4
# heads, word embedding 20, 12-wide regions, vocab 29 with UNK last
V, M = 29, 5
OPT = SimpleNamespace(
    caption_model='aoa', vocab_size=V, input_encoding_size=20, rnn_size=32,
    num_layers=2, drop_prob_lm=0.0, fc_feat_size=10, att_feat_size=12,
    att_hid_size=12, seq_per_img=5, max_length=8, num_heads=4)
VOCAB = dict({str(i): 'w%d' % i for i in range(1, V)}, **{str(V): 'UNK'})


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card')
    return torch.device('cuda', torch.cuda.current_device())


def _captioner(device, recorder=None):
    cap = setup(OPT, VOCAB, device).init_params(
        torch.Generator().manual_seed(0))
    cap.graph_recorder = recorder
    return cap


def _batch(device, B=4, seed=0):
    """fc, att [B, M, 12], att_masks (every other row ragged)."""
    rng = np.random.RandomState(seed)
    am = np.ones((B, M), 'float32')
    am[1::2, 3:] = 0
    return [torch.from_numpy(a).to(device) for a in (
        rng.randn(B, 10).astype('float32'),
        rng.randn(B, M, 12).astype('float32'), am)]


def test_without_a_stream_a_device_span_is_a_host_span():
    with tracing.device_span('d', None):
        pass
    with pytest.raises(KeyError):
        with tracing.device_span('d', None):
            raise KeyError('x')
    kept = tracing.intervals('d')
    assert len(kept) == 2 and all(a <= b for a, b in kept)


@pytest.mark.parametrize('profiled', [False, True])
def test_a_device_span_is_an_annotation_while_a_profiler_records(
        profiled, monkeypatch):
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
    with tracing.device_span('d', None):
        pass
    assert entered == (['d'] if profiled else [])


class _Event:
    """A timing event that has ``done`` (or not) and lies ``ms`` after
    the pending span's start event."""

    def __init__(self, done=True, ms=0.0):
        self.done, self.ms = done, ms

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_resolve_keeps_what_ended_oldest_first_and_waits_for_nothing():
    ev = [_Event() for _ in range(6)]
    ev[1].ms, ev[3].ms = 2.0, 0.5
    ev[5].done = False
    # a device index of its own: the pool is kept across resets
    pairs = [(ev[0], ev[1]), (ev[2], ev[3]), (ev[4], ev[5])]
    tracing._PENDING.extend([('a', 10.0, pairs[0], -1),
                             ('b', 11.0, pairs[1], -1),
                             ('a', 12.0, pairs[2], -1)])
    try:
        tracing.resolve()
        assert tracing.intervals('a') == [(10.0, 10.002)]
        assert tracing.intervals('b') == [(11.0, 11.0005)]
        assert len(tracing._PENDING) == 1
        # the resolved spans' events wait in the pool for the next span
        assert tracing._EVENTS[-1] == pairs[:2]
        ev[5].done, ev[5].ms = True, 1.0
        assert tracing.intervals('a') == [(10.0, 10.002), (12.0, 12.001)]
        assert not tracing._PENDING and tracing._EVENTS[-1] == pairs
    finally:
        tracing._EVENTS.pop(-1, None)


def test_reset_drops_the_pending():
    tracing._PENDING.append(('a', 1.0, (_Event(), _Event()), -1))
    tracing.reset()
    assert not tracing._PENDING and tracing.intervals('a') == []


def test_a_graph_decode_records_its_replays():
    cap = _captioner('cpu', EagerRecorder)
    for seed in (1, 2):
        fc, att, am = _batch('cpu', seed=seed)
        cap.sample_beam_graphed(fc, att, am, None, BEAM)
    entry, = cap._graph_cache.values()
    setups = tracing.intervals('decode.setup')
    steps = tracing.intervals('decode.step')
    assert len(setups) == entry.replays[0] == 2
    assert len(steps) == sum(entry.replays[1:])
    assert tracing.counters()['decode.steps'] == len(steps)
    # each call's setup precedes its steps, which follow one another
    ordered = sorted(setups + steps)
    assert all(b <= c for (_, b), (c, _) in zip(ordered, ordered[1:]))
    assert ordered[0] == setups[0]


@pytest.mark.chip
def test_on_the_card_spans_are_the_events_elapsed_times(cuda, monkeypatch):
    cap = _captioner(cuda)
    fc, att, am = _batch(cuda)
    cap.sample_beam_graphed(fc, att, am, None, BEAM)   # builds the graphs
    torch.cuda.synchronize()
    tracing.reset()
    elapsed = []
    real = torch.cuda.Event.elapsed_time

    def logged(self, end):
        ms = real(self, end)
        elapsed.append(ms)
        return ms

    def refuse(*a, **kw):
        raise AssertionError('a synchronize inside the decode')

    fc, att, am = _batch(cuda, seed=3)
    # a call resolves the spans whose work has ended by then
    monkeypatch.setattr(torch.cuda.Event, 'elapsed_time', logged)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, 'synchronize', refuse)
        m.setattr(torch.cuda.Event, 'synchronize', refuse)
        seq, stats, _ = cap.sample_beam_graphed(fc, att, am, None, BEAM)
    torch.cuda.synchronize()
    setups = tracing.intervals('decode.setup')
    steps = tracing.intervals('decode.step')
    assert len(setups) == 1 and len(steps) == tracing.counters()[
        'decode.steps'] >= 1
    spans = sorted(setups + steps)
    assert len(elapsed) == len(spans)
    for (a, b), ms in zip(spans, elapsed):
        assert b - a == pytest.approx(ms / 1e3, rel=1e-9, abs=1e-9)
        assert ms > 0
    want, want_stats, _ = cap.sample_beam(fc, att, am, None, BEAM)
    assert torch.equal(seq, want)
    torch.testing.assert_close(stats['lp_sum'], want_stats['lp_sum'])


@pytest.mark.chip
def test_on_the_card_events_are_pooled(cuda):
    cap = _captioner(cuda)
    fc, att, am = _batch(cuda)
    for _ in range(3):
        cap.sample_beam_graphed(fc, att, am, None, BEAM)
    torch.cuda.synchronize()
    tracing.resolve()
    made = len(tracing._EVENTS[cuda.index])
    for _ in range(3):
        cap.sample_beam_graphed(fc, att, am, None, BEAM)
    torch.cuda.synchronize()
    tracing.resolve()
    assert len(tracing._EVENTS[cuda.index]) == made
    assert len(tracing.intervals('decode.setup')) == 6
