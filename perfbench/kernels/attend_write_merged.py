"""B1, ``ops/beam_attend.py:attend_write_merged`` (``csrc/beam_attend.cu``):
one decode step's self-attention over the merged-lane caches through the
beam ancestry, the step's K/V written at slot t0.

Bytes (``chip_smoke.py:time_kernels``): q, k_new, v_new and ctx, the
written K/V entry, ancestry rows [N, t0] int32, and the cache entries
gathered.  How many distinct entries the gather reads depends on the
ancestry; the least, one slot a beam block a time (N / bw * t0 entries,
K and V each), is counted, so the bound is never above the true least
time.  Operations: 4 N D (t0 + 1) float32 (scores and context)."""

from perfbench import peaks

SYMBOLS = ('attend_write_kernel',)


def bound_s(s):
    N, D, bw, t0, e = s['N'], s['D'], s['bw'], s['t0'], s['dtype_bytes']
    entries = N // bw * t0
    nbytes = e * (3 * N * D + 2 * entries * D + 3 * N * D) + 4 * N * t0
    return peaks.bound_s(nbytes, 4.0 * N * D * (t0 + 1), peaks.F32)
