"""B6, ``ops/topk.py:topk_lastdim`` (``csrc/topk.cu``): the exact top-k of
each row of a float32 table, ties to the lowest index.

Bytes (``chip_smoke.py:time_new_kernels``): the float32 rows [B, C]
read once, the k values and int64 indices written.  Operations: B C compares
(float32)."""

from perfbench import peaks

SYMBOLS = ('topk_kernel',)


def bound_s(s):
    B, C, k = s['B'], s['C'], s['k']
    return peaks.bound_s(4 * B * C + 12 * B * k, float(B * C), peaks.F32)
