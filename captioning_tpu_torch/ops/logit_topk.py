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
``csrc/logit_topk.cu`` computes the product in the kernel body and keeps
the rest off device memory.  bf16: a block keeps its 128 rows of x in
shared memory (TMA, once), streams W through a ring of TMA loads, runs
the product on ``wgmma`` with two consumer warpgroups taking the 64-wide
vocab tiles in turn, and folds each tile from registers into per-thread
running stats (max, sum exp, sum exp*(t - m), sum t) and, behind a
K-th-best threshold, into each thread's own top-K list in registers.
float32 keeps a CUDA-core FMA product (``wgmma`` in float32 would be
TF32) staged in shared memory.
Blocks cannot carry state to one another, so the vocab splits
(``plan_splits``) write their partials to a small workspace and a second
kernel merges them per row.

Rounding mirrors the TPU kernel and the twin: the product is accumulated
in float32, rounded to the weight dtype, the bias (in the weight dtype) is
added with one more rounding, then everything is float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from .topk import top_k

MAX_K = 16
BF16_TILE, F32_TILE = 64, 128  # the kernels' vocab tiles
F32_ROWS = 64                  # the float32 kernel's row block
BF16_MAX_D = 1024              # x's block rows fit 128 KB of shared memory


def bf16_rows(D: int) -> int:
    """The bf16 kernel's row block: 128 rows (two wgmma halves) up to
    D 512, 64 up to D 1024."""
    return 128 if D <= 512 else 64


@functools.lru_cache(maxsize=None)
def plan_splits(N: int, V1: int, rows: int, tile: int, sms: int,
                blocks_per_sm: int = 1):
    """(splits, tiles per split) for a grid of ceil(N / rows) row blocks
    over ceil(V1 / tile) vocab tiles.

    The split count minimises the kernel's span counted in tile times:
    ceil(blocks / (sms * blocks_per_sm)) waves of (tiles per split + 1),
    the 1 for the block's load of its rows of x; the fewest splits win a
    tie.  Then as many splits as that width needs, so none is empty and
    split s covers tiles [s * per, min((s + 1) * per, tiles))."""
    tiles = -(-V1 // tile)
    row_blocks = -(-N // rows)
    slots = sms * blocks_per_sm
    best = min(range(1, tiles + 1),
               key=lambda s: (-(-row_blocks * s // slots)
                              * (-(-tiles // s) + 1), s))
    splits = -(-tiles // -(-tiles // best))
    return splits, -(-tiles // splits)   # the kernel's own tiles per split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bf16_refusal(D: int, x_ptr: int, w_ptr: int, b_ptr: int):
    """Why the bf16 kernel cannot take these operands, or None: TMA wants
    16-byte row strides and 16-byte aligned x and w, x's block rows must
    fit in shared memory, and the bias is read in aligned pairs."""
    if D % 8:
        return 'D %% 8 == 0 (D=%d)' % D
    if D > BF16_MAX_D:
        return 'D <= %d (D=%d)' % (BF16_MAX_D, D)
    if x_ptr % 16 or w_ptr % 16:
        return '16-byte aligned x and w'
    if b_ptr % 4:
        return '4-byte aligned b'
    return None


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
    CPU tensors take the plain twin; CUDA tensors launch the kernel, and
    operands it refuses raise.
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
    bf16 = w.dtype == torch.bfloat16
    if bf16:
        why = bf16_refusal(D, x.data_ptr(), w.data_ptr(), b.data_ptr())
        if why:
            raise ValueError('logit_topk: the bf16 kernel needs ' + why)
    if (not x.is_cuda or w.device != x.device or b.device != x.device
            or not w.is_contiguous() or x.shape != (N, D)
            or b.shape != (V1,)):
        raise ValueError('logit_topk: needs CUDA x [N, D], contiguous w '
                         '[V1, D] and b [V1] on one device')
    lib = _build.load('logit_topk')
    sms = _sm_count(x.device.index)
    if bf16:
        splits, _ = plan_splits(N, V1, bf16_rows(D), BF16_TILE, sms)
        parts = 2 * splits          # one per consumer warpgroup
    else:
        splits, _ = plan_splits(N, V1, F32_ROWS, F32_TILE, sms,
                                blocks_per_sm=2)
        parts = splits
    f32 = dict(dtype=torch.float32, device=x.device)
    ws_f = torch.empty(parts, N, 5 + k, **f32)
    ws_i = torch.empty(parts, N, k, dtype=torch.int32, device=x.device)
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
    _build.count_launch(logit_topk)
    return vals, idx.long(), row_sum, ent


_build.counted(logit_topk)
