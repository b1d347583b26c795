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
- ``decode.setup`` and ``decode.step`` (``GraphDecode.__call__``: the
  replay of the setup graph, i.e. the prepare and the bos step, and the
  replay of one step's graph), device spans; the counter
  ``decode.steps``, the step graphs a call replayed;
- ``model.install`` (``models/api.Captioner._install``);
- ``kernels.load`` (``ops/_build.load``, a library bound at first use; the
  counter ``kernels.nvcc``, one a source that nvcc compiled).

``device_span(name, stream)`` times work enqueued on a CUDA stream: CUDA
timing events on it before and after the block, a pair from a pool.  Nothing waits for them: ``resolve()`` keeps each pair whose
end event has completed (a query, no synchronize) as the interval (the
block's host start, that start + the events' elapsed time) in the same
ring as a host span's, and leaves the others for a later call.
``GraphDecode.__call__``, ``intervals`` and ``summary`` resolve.  On a
device other than CUDA a device span is a host span.

``intervals(name, lo, hi)`` gives a span's intervals inside a stretch of
the same clock, ``summary()`` a table of every span and counter.
"""

from __future__ import annotations

import collections
import threading
from time import perf_counter
from typing import Dict, List, Optional, Tuple

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

# the intervals each span name keeps: a 51 s window of batches of 70 ms
# records about 730 of each eval span and 15,000 ``decode.step``s
RING = 16384


class _Record:
    __slots__ = ('ring', 'n', 'total')

    def __init__(self):
        self.ring = collections.deque(maxlen=RING)
        self.n = 0
        self.total = 0.0


_SPANS: Dict[str, _Record] = {}
_COUNTERS: Dict[str, int] = {}
# device spans not yet resolved: (name, host start, (start event, end
# event), device index), in the order they ended; pairs of timing events
# free for reuse, by device index
_PENDING: collections.deque = collections.deque()
_EVENTS: Dict[int, list] = {}
_LOCK = threading.Lock()


def _keep(name: str, start: float, end: float) -> None:
    rec = _SPANS.get(name)
    if rec is None:
        rec = _SPANS[name] = _Record()
    rec.ring.append((start, end))
    rec.n += 1
    rec.total += end - start


def record(name: str, start: float, end: float) -> None:
    """Keep the interval (start, end) of ``perf_counter`` seconds as one of
    span ``name``."""
    with _LOCK:
        _keep(name, start, end)


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


class device_span(span):
    """``with device_span(name, stream):`` times the work the block
    enqueues on the CUDA ``stream`` (``resolve``); while a profiler
    records, the block is also a ``record_function(name)``.  With
    ``stream`` None (no CUDA device), a ``span``."""

    __slots__ = ('stream', 'events')

    def __init__(self, name: str, stream):
        super().__init__(name)
        self.stream = stream

    def __enter__(self):
        super().__enter__()
        if self.stream is not None:
            with _LOCK:
                free = _EVENTS.get(self.stream.device_index)
                pair = free.pop() if free else None
            if pair is None:
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            pair[0].record(self.stream)
            self.events = pair
        return self

    def __exit__(self, *exc):
        if self.stream is None:
            return super().__exit__(*exc)
        self.events[1].record(self.stream)
        with _LOCK:
            _PENDING.append((self.name, self.start, self.events,
                             self.stream.device_index))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def resolve() -> None:
    """Keep the pending device spans whose work has ended, oldest first,
    up to the first still running; their events go back to the pool.
    Waits for nothing."""
    with _LOCK:
        while _PENDING:
            name, start, (begin, end), index = _PENDING[0]
            if not end.query():
                break
            _PENDING.popleft()
            _keep(name, start, start + begin.elapsed_time(end) / 1e3)
            _EVENTS.setdefault(index, []).append((begin, end))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def intervals(name: str, lo: Optional[float] = None,
              hi: Optional[float] = None) -> List[Tuple[float, float]]:
    """The kept (start, end) intervals of span ``name`` that lie inside
    [lo, hi] (an open side where None), oldest first."""
    resolve()
    with _LOCK:
        rec = _SPANS.get(name)
        ring = list(rec.ring) if rec is not None else []
    return [(a, b) for a, b in ring
            if (lo is None or a >= lo) and (hi is None or b <= hi)]


def counters() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Forget every span and counter, and the pending device spans."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
        _PENDING.clear()


def _rank(xs, q):
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def summary() -> str:
    """One line a span (its count and mean over every interval, p50 and
    p95 over the kept ones, in ms) and one a counter, by name."""
    resolve()
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
