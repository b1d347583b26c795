"""The arithmetic of the metric readers (``metrics/<name>.py``), each a
function of the run's record (``loops/<loop>.py``) that returns None
where the record holds nothing to read."""

from __future__ import annotations

import statistics

from perfbench import harness, trace


def rate(rec, kind):
    """Work completed over the window's wall: captions (eval) or images
    (train) a second."""
    if rec.get('kind') != kind or not rec.get('window_s'):
        return None
    return rec['work'] / rec['window_s']


def p95_interval_ms(rec):
    """The 95th percentile of the intervals between consecutive
    completions in the window (``marks``, the window's end last)."""
    marks = rec.get('marks') or []
    steps = [b - a for a, b in zip(marks, marks[1:])]
    if len(steps) < 20:
        return None
    return 1000 * statistics.quantiles(steps, n=20, method='inclusive')[18]


def device_idle_pct(rec, kind):
    """100 x (1 - the union of the kernels' intervals / the profiled
    sub-window)."""
    tr = rec.get('trace')
    if rec.get('kind') != kind or not tr:
        return None
    return 100.0 * (1.0 - tr['kernel_busy_s'] / tr['window_s'])


def mfu_pct(rec, kind):
    """The model FLOPs of the window's work over its wall, against the
    card's dense bf16 peak."""
    if rec.get('kind') != kind or not rec.get('flops') or \
            not rec.get('peak_flops'):
        return None
    return 100.0 * rec['flops'] / rec['window_s'] / rec['peak_flops']


def kernel_roofline_pct(rec, kind):
    """100 x the hand-written kernels' least time at the shapes they ran
    (``kernels/<wrapper>.py``, each launch of the profiled sub-window) over
    their device time there."""
    tr = rec.get('trace')
    if rec.get('kind') != kind or not tr or not tr.get('launches'):
        return None
    least, spent = 0.0, 0.0
    for name, runs in tr['launches'].items():
        if any(shape is None for shape, _ in runs):
            return None
        k = harness.module('kernels', name)
        least += sum(k.bound_s(shape) * n for shape, n in runs)
        spent += trace.family_time(tr['kernels'], k.SYMBOLS)
    return 100.0 * least / spent if spent > 0 else None


def span_mean_ms(rec, span):
    xs = (rec.get('spans') or {}).get(span)
    return 1000.0 * sum(xs) / len(xs) if xs else None


def h2d_ms(rec):
    """The device time of host-to-device copies a batch, profiled."""
    tr = rec.get('trace')
    if not tr or not tr.get('batches'):
        return None
    return 1000.0 * tr['h2d_s'] / tr['batches']
