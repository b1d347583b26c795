"""The ``program_span`` readers (``spans.py`` and the four
``metrics/*.eval.py`` that use it) against a hand-built ring of the
program's tracing module and a record: the window's bounds, set-up
before its start, and None without ``marks`` or without the module."""

import sys

import pytest

from perfbench import harness
from perfbench.tests import tiny

tracing = pytest.importorskip('captioning_tpu_torch.utils.tracing')

EVAL = ['transformer.eval_beam5', 'updown.eval_beam5']
# metric -> the span it reads
WINDOW = {'h2d_host_ms.eval': 'eval.h2d', 'post_ms.eval': 'eval.post'}
SETUP = {'graph_capture_s.eval': 'graph.capture',
         'install_s.eval': 'model.install'}
# a window of 10 s ending at 110 s: t0 = 100
REC = {'marks': [100.5, 104.0, 107.0, 110.0], 'window_s': 10.0}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _read(metric, rec):
    return harness.module('metrics', metric).read(rec)


@pytest.mark.parametrize('metric', sorted(WINDOW))
def test_window_mean_reads_only_what_lies_inside(metric):
    span = WINDOW[metric]
    for a, b in [(95.0, 99.0),          # set-up
                 (99.9, 100.1),         # straddles t0
                 (100.0, 100.002),      # inside, from t0 on
                 (105.0, 105.004),
                 (109.994, 110.0),      # inside, up to t1
                 (109.999, 110.5),      # straddles t1: the traced pass
                 (111.0, 120.0)]:       # after the window
        tracing.record(span, a, b)
    tracing.record('eval.other', 101.0, 109.0)
    assert _read(metric, REC) == pytest.approx(4.0)


@pytest.mark.parametrize('metric', sorted(SETUP))
def test_setup_sum_reads_what_ended_before_the_window(metric):
    span = SETUP[metric]
    for a, b in [(1.0, 1.5), (3.0, 5.25),   # set-up
                 (99.0, 100.0),             # ends at t0
                 (99.5, 100.5),             # ends inside the window
                 (111.0, 113.0)]:           # after it
        tracing.record(span, a, b)
    assert _read(metric, REC) == pytest.approx(0.5 + 2.25 + 1.0)


@pytest.mark.parametrize('metric', sorted(WINDOW) + sorted(SETUP))
@pytest.mark.parametrize('rec', [{}, {'marks': [], 'window_s': 10.0},
                                 {'marks': [110.0]}, REC])
def test_none_without_marks_or_intervals(metric, rec):
    """No marks, no window or no interval of the span: nothing to read."""
    tracing.record('eval.other', 1.0, 2.0)
    assert _read(metric, rec) is None


@pytest.mark.parametrize('metric', sorted(WINDOW) + sorted(SETUP))
def test_none_from_a_program_without_the_module(metric, monkeypatch):
    """The parent of the tracing module: the reader finds nothing and
    does not raise."""
    import captioning_tpu_torch.utils as utils
    tracing.record(dict(WINDOW, **SETUP)[metric], 100.0, 101.0)
    monkeypatch.delattr(utils, 'tracing')
    monkeypatch.setitem(sys.modules, 'captioning_tpu_torch.utils.tracing',
                        None)
    assert _read(metric, REC) is None


@pytest.mark.parametrize('name', EVAL)
def test_the_loop_gives_the_span_metrics(name):
    """The cell's loop at CPU sizes: the window's copies and strings and
    the set-up's install read; a CPU captioner builds no graph decode."""
    c = tiny.cell(name)
    rec = c.loop().run(tiny.context(c, 2 ** 31 + 11))
    got = {m: _read(m, rec) for m in list(WINDOW) + list(SETUP)}
    assert got['h2d_host_ms.eval'] > 0 and got['post_ms.eval'] > 0
    assert got['install_s.eval'] > 0
    assert got['graph_capture_s.eval'] is None
    t0 = rec['marks'][-1] - rec['window_s']
    splits = tracing.intervals('eval.split', t0, rec['marks'][-1])
    assert splits and len(tracing.intervals('eval.save', t0,
                                            rec['marks'][-1])) == len(splits)
