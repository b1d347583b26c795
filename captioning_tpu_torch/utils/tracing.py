"""Spans and counters of the port's host work: the counterpart of the JAX
package's ``utils/profiling.annotate``.

``span(name)`` times a stretch of host work on ``time.perf_counter()``
and keeps its (start, end) in a ring of the ``RING`` latest intervals of
that name, with a running count and sum; ``count(name, n)`` adds to a
counter.  The host accounting is always on, as an operator's counters
are: a span costs one check of the profiler's flag and two clock reads.
While ``torch.profiler`` records, a span also enters
``torch.profiler.record_function(name)``, so it lands in the profiler's
trace as a ``user_annotation`` on the clock of the kernels and copies::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as p:
        eval_utils.eval_split(captioner, loader, opt)
    p.export_chrome_trace('trace.json')     # chrome://tracing, Perfetto

Under ``torch.autograd.profiler.emit_nvtx()`` (a CUDA build) the same
spans become NVTX ranges, which Nsight Systems shows beside the kernels
(``nsys profile -t cuda,nvtx python ...``).

The spans in the port, each where its work happens:

- ``eval.split`` (``utils/eval_utils.eval_split``, the whole call, kept by
  ``record`` on the host clock alone: as an annotation it would name every
  idle gap that straddles two of its parts), and inside it ``eval.load``
  (the loader's ``get_batch``), ``eval.h2d`` (the wait for the batch's
  copy to the device, the part the strings before did not hide; the
  counters ``eval.h2d_bytes`` and ``eval.h2d_hidden``, one a batch whose
  copy had ended by then), ``eval.decode`` (the decode entry),
  ``eval.post`` (a batch's captions read back, the strings and the
  entries), ``eval.save`` (the pickle of the pass) and ``eval.lang``
  (``language_eval``); beside them ``eval.stage`` (``utils.staging``'s
  worker, from a batch's start to its last copy enqueued; ``record``
  alone, as ``eval.split``);
- ``graph.capture`` (``engine/graphs.GraphDecode``: the warm decode and
  the captures; the counter ``graph.captures``, one a graph decode built);
- ``model.install`` (``models/api.Captioner._install``);
- ``kernels.load`` (``ops/_build.load``, a library bound at first use; the
  counter ``kernels.nvcc``, one a source that nvcc compiled).

``intervals(name, lo, hi)`` gives a span's intervals inside a stretch of
the same clock, ``summary()`` a table of every span and counter.
"""

from __future__ import annotations

import collections
import threading
from time import perf_counter
from typing import Dict, List, Optional, Tuple

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

# the intervals each span name keeps: a 51 s window of batches of 120 ms
# records about 420 of each eval span
RING = 4096


class _Record:
    __slots__ = ('ring', 'n', 'total')

    def __init__(self):
        self.ring = collections.deque(maxlen=RING)
        self.n = 0
        self.total = 0.0


_SPANS: Dict[str, _Record] = {}
_COUNTERS: Dict[str, int] = {}
_LOCK = threading.Lock()


def record(name: str, start: float, end: float) -> None:
    """Keep the interval (start, end) of ``perf_counter`` seconds as one of
    span ``name``."""
    with _LOCK:
        rec = _SPANS.get(name)
        if rec is None:
            rec = _SPANS[name] = _Record()
        rec.ring.append((start, end))
        rec.n += 1
        rec.total += end - start


class span:
    """``with span(name):`` records the block's host interval; while a
    profiler records, the block is also a ``record_function(name)``."""

    __slots__ = ('name', 'start', 'annotation')

    def __init__(self, name: str):
        self.name = name
        self.annotation = None

    def __enter__(self):
        if _profiler_enabled():
            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        self.start = perf_counter()
        return self

    def __exit__(self, *exc):
        end = perf_counter()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        record(self.name, self.start, end)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def intervals(name: str, lo: Optional[float] = None,
              hi: Optional[float] = None) -> List[Tuple[float, float]]:
    """The kept (start, end) intervals of span ``name`` that lie inside
    [lo, hi] (an open side where None), oldest first."""
    with _LOCK:
        rec = _SPANS.get(name)
        ring = list(rec.ring) if rec is not None else []
    return [(a, b) for a, b in ring
            if (lo is None or a >= lo) and (hi is None or b <= hi)]


def counters() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Forget every span and counter."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def _rank(xs, q):
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def summary() -> str:
    """One line a span (its count and mean over every interval, p50 and
    p95 over the kept ones, in ms) and one a counter, by name."""
    with _LOCK:
        spans = {k: (r.n, r.total, sorted(b - a for a, b in r.ring))
                 for k, r in _SPANS.items()}
        counts = dict(_COUNTERS)
    lines = []
    for name in sorted(spans):
        n, total, kept = spans[name]
        lines.append('span %-16s n %6d  mean %10.3f ms  p50 %10.3f ms  '
                     'p95 %10.3f ms' % (name, n, 1e3 * total / n,
                                        1e3 * _rank(kept, 0.5),
                                        1e3 * _rank(kept, 0.95)))
    for name in sorted(counts):
        lines.append('count %-15s %d' % (name, counts[name]))
    return '\n'.join(lines)
