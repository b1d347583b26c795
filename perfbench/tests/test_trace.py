"""The profiled sub-window's reading of a chrome trace, and the metric
readers over a run's record."""

import pytest

from perfbench import harness, readers, trace


def _x(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}


EVENTS = [
    _x(trace.WINDOW, 'user_annotation', 0, 100),
    _x('void attend_write_kernel<bf16>(...)', 'kernel', 10, 20),
    _x('gemm', 'kernel', 20, 20),           # overlaps the first
    _x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 50, 10),
    _x('logit_topk_wgmma<2, 5>', 'kernel', 95, 10),   # cut at the end
    _x('aten::to', 'cpu_op', 45, 20),
    _x('cudaGraphLaunch', 'cuda_runtime', 62, 30),
]


def test_union_and_gaps():
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_read():
    r = trace.read(EVENTS)
    assert r['window_s'] == pytest.approx(100e-6)
    assert r['kernel_busy_s'] == pytest.approx(35e-6)    # 10-40, 95-100
    assert r['busy_s'] == pytest.approx(45e-6)
    assert r['h2d_s'] == pytest.approx(10e-6)
    assert trace.family_time(r['kernels'], ('attend_write_kernel',)) == \
        pytest.approx(20e-6)
    assert trace.family_time(r['kernels'], ('logit_topk',)) == 0
    # the longest gap (60-95) is the graph launch's; (0-10) no host event
    assert r['idle_gaps'][0] == ['cudaGraphLaunch', pytest.approx(35e-6)]
    assert ['python', pytest.approx(10e-6)] in r['idle_gaps']


def test_no_kernel_raises():
    with pytest.raises(RuntimeError):
        trace.read([EVENTS[0], EVENTS[3]])


def test_readers():
    rec = {'kind': 'eval', 'window_s': 2.0, 'work': 10000.0,
           'marks': [0.1 * i for i in range(21)] + [2.5], 'flops': 4e13,
           'peak_flops': 1e15, 'setup_s': 3.0,
           'spans': {'decode': [0.1, 0.3]},
           'trace': {'kernel_busy_s': 0.6, 'window_s': 1.0, 'h2d_s': 0.2,
                     'batches': 4, 'kernels': {'topk_kernel<5>': 0.5},
                     'launches': {'topk_lastdim': [
                         (dict(B=1000, C=47440, k=5), 100)]}}}
    assert readers.rate(rec, 'eval') == 5000
    assert readers.rate(rec, 'train') is None
    # 21 intervals, one of 500 ms: its 95th percentile is the 20th of 100
    assert readers.p95_interval_ms(rec) == pytest.approx(100.0)
    assert readers.device_idle_pct(rec, 'eval') == pytest.approx(40.0)
    assert readers.mfu_pct(rec, 'eval') == pytest.approx(2.0)
    assert readers.span_mean_ms(rec, 'decode') == pytest.approx(200.0)
    assert readers.h2d_ms(rec) == pytest.approx(50.0)
    least = harness.module('kernels', 'topk_lastdim').bound_s(
        dict(B=1000, C=47440, k=5)) * 100
    assert readers.kernel_roofline_pct(rec, 'eval') == pytest.approx(
        100 * least / 0.5)
    # a launch whose shape is unknown reads nothing, never 0
    rec['trace']['launches']['topk_lastdim'] = [(None, 0)]
    assert readers.kernel_roofline_pct(rec, 'eval') is None
