"""Fused vocab epilogue: x.W + b, log-softmax, stats and per-row top-k.

Replaces the TPU kernel ``captioning_tpu/ops/logit_topk.py:
_logit_topk_kernel`` (wrapper ``logit_topk``).  Per row of x it returns
the top-k UNK-adjusted log-softmax values and their indices (ties to the
lowest index, as ``lax.top_k``), ``row_sum = sum(lsm')`` and
``ent = -sum(exp(lsm') * lsm')``, where ``lsm = log_softmax((x.W + b) /
temp)`` and ``lsm' = lsm + unk_bias`` at ``unk_idx`` (after the softmax).
The [N, V1] table is never stored.

What bounds it on the H100: at the beam-5 B = 1024 step (N = 5120,
D = 512, V1 = 9488) the product is 50 GFLOP against ~10 MB of weights and
5 MB of activations — far above the 295 FLOP/byte ridge, so compute.
``csrc/logit_topk.cu`` computes the product in the kernel body — bf16
tensor-core fragments (``nvcuda::wmma``) with float32 accumulation for
bf16, float32 FMA for float32 (``wgmma``/TMA are later work) — and keeps
the rest off device memory: a block owns 64 rows and one contiguous range
of 128-column vocab tiles, folding each tile into flash-style running
stats (max, sum exp over the raw logits, sum exp and sum exp*(t - m) over
the adjusted ones, sum of the adjusted ones) and into a running top-k held
in shared memory.  Blocks cannot carry state to one another, so the vocab
splits (chosen to give about two blocks per SM: the greedy batch has 5x
fewer rows than the beam one) write their partials to a small workspace
and a second kernel merges them per row.

Rounding mirrors the TPU kernel and the twin: the product is accumulated
in float32, rounded to the weight dtype, the bias (in the weight dtype) is
added with one more rounding, then everything is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .topk import top_k

MAX_K = 16
_ROWS, _TV = 64, 128          # the kernel's row block and vocab tile


def _splits(N: int, V1: int, device) -> int:
    """Vocab splits per row block: enough blocks for about two per SM,
    no split without a tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-V1 // _TV)
    want = max(1, min(tiles, -(-2 * sms // -(-N // _ROWS))))
    per = -(-tiles // want)
    return -(-tiles // per)


def logit_topk_ref(x, w, b, temp=1.0, unk_bias=0.0, *, k: int,
                   unk_idx: int = -1):
    """Plain twin (materialized table): the JAX ``logit_topk_ref`` with the
    weight in nn.Linear layout w [V1, D]."""
    logits = (F.linear(x.to(w.dtype), w) + b.to(w.dtype)).float()
    lsm = torch.log_softmax(logits / temp, dim=-1)
    if unk_idx >= 0:
        lsm[:, unk_idx] += unk_bias
    row_sum = lsm.sum(-1)
    ent = -(lsm.exp() * lsm).sum(-1)
    tv, ti = top_k(lsm, k)
    return tv, ti, row_sum, ent


def logit_topk(x, w, b, temp=1.0, unk_bias=0.0, *, k: int,
               unk_idx: int = -1):
    """Fused generator + log-softmax + stats + per-row top-k.

    x: [N, D] (cast to w.dtype); w: [V1, D]; b: [V1].  Returns (top_lsm
    [N, k] f32, top_ix [N, k] int64, row_sum [N] f32, ent [N] f32).
    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    V1, D = w.shape
    if not 1 <= k <= min(MAX_K, V1):
        raise ValueError('logit_topk: k=%d outside 1..%d' % (k, MAX_K))
    if not -1 <= unk_idx < V1:
        raise ValueError('logit_topk: unk_idx=%d outside -1..V1-1' % unk_idx)
    if x.device.type == 'cpu':
        return logit_topk_ref(x, w, b, temp, unk_bias, k=k, unk_idx=unk_idx)
    x = x.to(w.dtype).contiguous()
    b = b.to(w.dtype).contiguous()
    N = x.shape[0]
    if (not x.is_cuda or w.device != x.device or b.device != x.device
            or not w.is_contiguous() or x.shape != (N, D)
            or b.shape != (V1,)):
        raise ValueError('logit_topk: needs CUDA x [N, D], contiguous w '
                         '[V1, D] and b [V1] on one device')
    if w.dtype == torch.bfloat16 and (D % 8 or x.data_ptr() % 16
                                      or w.data_ptr() % 16):
        raise ValueError('logit_topk: bf16 needs D % 8 == 0 and 16-byte '
                         'aligned x and w')
    lib = _build.load('logit_topk')
    splits = _splits(N, V1, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    ws_f = torch.empty(splits, N, 5 + k, **f32)
    ws_i = torch.empty(splits, N, k, dtype=torch.int32, device=x.device)
    vals = torch.empty(N, k, **f32)
    idx = torch.empty(N, k, dtype=torch.int32, device=x.device)
    row_sum = torch.empty(N, **f32)
    ent = torch.empty(N, **f32)
    rc = lib.logit_topk(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), ws_f.data_ptr(),
        ws_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), row_sum.data_ptr(),
        ent.data_ptr(), N, D, V1, k, unk_idx, splits, float(temp),
        float(unk_bias), _build.dtype_code(w.dtype),
        _build.stream_ptr(x.device))
    _build.check(rc, 'logit_topk')
    logit_topk.launches += 1
    return vals, idx.long(), row_sum, ent


logit_topk.launches = 0
