"""The ``aoa.eval_beam5`` cell at tiny widths on the CPU: a whole run of
the cell's loop, whose check reads rounding; and the readers of the
decode's device spans (``prepare_ms.eval``, ``step_ms.eval``) against a
hand-built ring.  The port is held to the reference at tiny widths by
``tests/test_torch_aoa_reference.py``."""

import sys

import pytest

from perfbench import harness
from perfbench.tests import tiny

tracing = pytest.importorskip('captioning_tpu_torch.utils.tracing')

# metric -> the span it reads; a window of 10 s ending at 110 s
WINDOW = {'prepare_ms.eval': 'decode.setup', 'step_ms.eval': 'decode.step'}
REC = {'marks': [100.5, 104.0, 107.0, 110.0], 'window_s': 10.0}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


def _read(metric, rec):
    return harness.module('metrics', metric).read(rec)


def test_cell_on_cpu_agrees():
    """A whole run of the cell's loop on the CPU in float32: the check's
    numbers are rounding; a CPU captioner builds no graph decode, so the
    decode's device spans read nothing."""
    c = tiny.cell('aoa.eval_beam5')     # widths from perfbench/conftest.py
    rec = c.loop().run(tiny.context(c, 2 ** 31 + 5))
    assert rec['attempted'] > 0 and rec['failed'] == 0
    assert all(v < 1e-4 for v in rec['check'].values()), rec['check']
    assert all(_read(m, rec) is None for m in WINDOW)


@pytest.mark.parametrize('metric', sorted(WINDOW))
def test_window_mean_of_the_device_spans(metric):
    span = WINDOW[metric]
    for a, b in [(95.0, 99.0),          # set-up
                 (100.0, 100.002),      # inside
                 (109.994, 110.0),
                 (109.999, 110.5)]:     # the traced pass
        tracing.record(span, a, b)
    assert _read(metric, REC) == pytest.approx(4.0)
    assert _read(metric, {}) is None


@pytest.mark.parametrize('metric', sorted(WINDOW))
def test_none_from_a_program_without_the_spans(metric, monkeypatch):
    """The parent of the device spans records none; a program without the
    tracing module is read as nothing too."""
    tracing.record('eval.post', 101.0, 102.0)
    assert _read(metric, REC) is None
    import captioning_tpu_torch.utils as utils
    monkeypatch.delattr(utils, 'tracing')
    monkeypatch.setitem(sys.modules, 'captioning_tpu_torch.utils.tracing',
                        None)
    assert _read(metric, REC) is None
