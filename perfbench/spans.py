"""The program's own spans (``captioning_tpu_torch.utils.tracing``) on the
benchmark's clock, for the ``program_span`` readers of ``metrics/``.

The window ends at the record's last mark (``t1``, the loop's
``perf_counter()`` after its closing synchronize) and starts
``window_s`` before it (``t0``); set-up is every span that ended before
``t0``.  A span counts in the window when it lies inside [t0, t1].  A
record without ``marks``, or a program without the tracing module, gives
None, as does a span with no interval there.
"""

from __future__ import annotations


def _tracing():
    try:
        from captioning_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def window(rec):
    """(t0, t1) of the record's window, or None."""
    marks = rec.get('marks')
    if not marks or not rec.get('window_s'):
        return None
    t1 = float(marks[-1])
    return t1 - float(rec['window_s']), t1


def window_mean_ms(rec, name):
    """The mean wall of span ``name`` inside the window, ms."""
    tracing, win = _tracing(), window(rec)
    if tracing is None or win is None:
        return None
    xs = tracing.intervals(name, *win)
    return 1000.0 * sum(b - a for a, b in xs) / len(xs) if xs else None


def setup_sum_s(rec, name):
    """The summed wall of span ``name`` over set-up, s."""
    tracing, win = _tracing(), window(rec)
    if tracing is None or win is None:
        return None
    xs = tracing.intervals(name, hi=win[0])
    return sum(b - a for a, b in xs) if xs else None
