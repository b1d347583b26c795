"""The profiled sub-window of a ``--trace 1`` run: ``torch.profiler`` over
a few steady batches or steps, read from its chrome trace.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events (a CUDA graph's replay reaches the profiler kernel
by kernel), clipped to the sub-window, the span of the
``perfbench_window`` annotation that encloses the work and its final
synchronize.  Busy time is the union of their intervals, never a sum of
self times: overlapping operations count once.
"""

from __future__ import annotations

import json
import os
import re

WINDOW = 'perfbench_window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('user_annotation', 'cpu_op', 'cuda_runtime', 'cuda_driver')


def union(intervals):
    """The total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo, hi):
    """The uncovered (start, end) stretches of [lo, hi]."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def profile(fn, tmpdir):
    """Run ``fn()`` under the profiler; returns (what ``fn`` returned, the
    parsed sub-window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_
    from torch.profiler import record_function
    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    path = os.path.join(tmpdir, 'perfbench_trace.json')
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    return out, read(events)


def read(events):
    """{'window_s', 'busy_s', 'kernel_busy_s', 'h2d_s', 'kernels' {name:
    seconds}, 'device_ops' [[name, s]], 'idle_gaps' [[host activity, s]],
    'kernel_launches' {name: count}} of a chrome trace's events."""
    xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    win = [e for e in xs if e.get('name') == WINDOW]
    if not win:
        raise RuntimeError('trace: no %s span' % WINDOW)
    lo = float(win[0]['ts'])
    hi = lo + float(win[0]['dur'])
    dev, kern, h2d = [], [], 0.0
    by_name, launches = {}, {}
    for e in xs:
        if e.get('cat') not in DEVICE_CATS:
            continue
        a = max(float(e['ts']), lo)
        b = min(float(e['ts']) + float(e['dur']), hi)
        if b <= a:
            continue
        dev.append((a, b))
        name = e['name']
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if e['cat'] == 'kernel':
            kern.append((a, b))
            launches[name] = launches.get(name, 0) + 1
        elif 'HtoD' in name:
            h2d += (b - a) * 1e-6
    if not kern:
        raise RuntimeError('trace: no kernel ran on the device in the '
                           'profiled window')
    host = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                   e['name']) for e in xs
                  if e.get('cat') in HOST_CATS and e['name'] != WINDOW)
    longest = sorted(gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
    idle = [[_host_activity(host, a, b), (b - a) * 1e-6]
            for a, b in longest]
    ops = sorted(by_name.items(), key=lambda x: -x[1])
    return {'window_s': (hi - lo) * 1e-6, 'busy_s': union(dev) * 1e-6,
            'kernel_busy_s': union(kern) * 1e-6, 'h2d_s': h2d,
            'kernels': by_name, 'kernel_launches': launches,
            'device_ops': [[n, s] for n, s in ops[:10]],
            'idle_gaps': idle}


def _host_activity(host, a, b):
    """What the host was doing over (a, b): the host event that overlaps
    it most, the innermost (shortest) of equals; 'python' where no traced
    host event does."""
    best, key = 'python', None
    for s, e, name in host:
        if s >= b:
            break
        over = min(e, b) - max(s, a)
        if over <= 0:
            continue
        k = (over, -(e - s))
        if key is None or k > key:
            best, key = name, k
    return best


def family_time(kernels, symbols):
    """The seconds of the kernels whose CUDA function is one of
    ``symbols``."""
    pat = re.compile(r'(?<![A-Za-z0-9_])(%s)(?![A-Za-z0-9_])'
                     % '|'.join(map(re.escape, symbols)))
    return sum(s for name, s in kernels.items() if pat.search(name))
