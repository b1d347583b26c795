"""B2, ``ops/logit_topk.py:logit_topk`` (``csrc/logit_topk.cu``): the
vocab projection, log-softmax, row stats and per-row top-k of N hidden
rows, the logits never in memory.

Bytes (``chip_smoke.py:time_kernels``): x [N, D], W [V1, D] and b in the
compute dtype, the top-k values (float32) and int32 indices, row sum and
entropy.  Operations: 2 N D V1 on the tensor cores (bf16)."""

from perfbench import peaks

SYMBOLS = ('logit_topk_wgmma', 'logit_topk_split', 'logit_topk_merge')


def bound_s(s):
    N, D, V1, k, e = s['N'], s['D'], s['V1'], s['k'], s['dtype_bytes']
    nbytes = e * (N * D + V1 * D + V1) + N * k * 8 + N * 8
    return peaks.bound_s(nbytes, 2.0 * N * D * V1,
                         peaks.BF16_TENSOR if e == 2 else peaks.F32)
