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

Shard mode (the model axis, ``parallel/vocab.py``): a rank holds the rows
[v_off, v_off + V1 / M) of w and b.  ``logit_topk(..., v_off=, V1=,
parts_only=True)`` runs the split kernel over the shard and returns its
workspace (global indices; ``unk_idx`` applies in the shard that holds
it); ``logit_topk_sharded`` all-gathers the model group's parts (not the
[N, V1] table) and ``logit_topk_merge_parts`` merges them with the global
V1, so every rank of the group gets the same top-k, row_sum and entropy.
Their plain twins, ``logit_topk_parts_ref`` and ``logit_topk_merge_ref``,
do the same partial and merge arithmetic.

Rounding mirrors the TPU kernel and the twin: the product is accumulated
in float32, rounded to the weight dtype, the bias (in the weight dtype) is
added with one more rounding, then everything is float32.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
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


# the index of an empty top-k slot (the kernels' INT_MAX)
EMPTY = 2 ** 31 - 1


def logit_topk_parts_ref(x, w, b, temp=1.0, unk_bias=0.0, *, k: int,
                         unk_idx: int = -1, v_off: int = 0):
    """Plain twin of a shard's part, as the split kernels write it: wf [1,
    N, 5 + k] = (m, S, S', E', sum t', the top-k values of t') and wi [1,
    N, k] int32 (global indices, v_off + local), where t = (x.w + b) /
    temp over the shard's columns, m = max t, S = sum exp(t - m), t' = t
    + unk_bias at the local column ``unk_idx`` (-1: none), S' = sum exp(t'
    - m), E' = sum exp(t' - m) (t' - m).  Slots past the shard's width
    hold -inf and ``EMPTY``."""
    t = (F.linear(x.to(w.dtype), w) + b.to(w.dtype)).float() / temp
    m = t.max(-1).values
    s = (t - m[:, None]).exp().sum(-1)
    if unk_idx >= 0:
        t[:, unk_idx] += unk_bias
    d = t - m[:, None]
    e = d.exp()
    n = min(k, t.shape[1])
    tv, ti = top_k(t, n)
    vals = torch.full((t.shape[0], k), float('-inf'), device=t.device)
    idx = torch.full((t.shape[0], k), EMPTY, dtype=torch.int32,
                     device=t.device)
    vals[:, :n] = tv
    idx[:, :n] = (ti + v_off).int()
    wf = torch.cat([torch.stack([m, s, e.sum(-1), (e * d).sum(-1),
                                 t.sum(-1)], 1), vals], 1)
    return wf[None], idx[None]


def logit_topk_merge_ref(wf, wi, V1: int, k: int):
    """Plain twin of ``logit_topk_merge_parts``: the parts wf [P, N, 5 + k]
    / wi [P, N, k] combined per row (the stats rescaled to the largest m,
    the lists merged under (value desc, index asc)), the log-softmax
    constant c = M + log S taken off, row_sum = sum t' - V1 c."""
    m = wf[..., 0]
    top = m.max(0).values
    r = (m - top).exp()
    s = (wf[..., 1] * r).sum(0)
    sp = (wf[..., 2] * r).sum(0)
    ep = (r * (wf[..., 3] + (m - top) * wf[..., 2])).sum(0)
    ts = wf[..., 4].sum(0)
    N = wf.shape[1]
    vals = wf[..., 5:].permute(1, 0, 2).reshape(N, -1)
    idx = wi.permute(1, 0, 2).reshape(N, -1).long()
    # index ascending, then a stable sort by value descending
    order = idx.argsort(dim=-1, stable=True)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    order = vals.argsort(dim=-1, descending=True, stable=True)[:, :k]
    logs = s.log()
    c = top + logs
    return (vals.gather(1, order) - c[:, None], idx.gather(1, order),
            ts - V1 * c, -(ep - logs * sp) / s)


def logit_topk(x, w, b, temp=1.0, unk_bias=0.0, *, k: int,
               unk_idx: int = -1, v_off: int = 0, V1: int = None,
               parts_only: bool = False):
    """Fused generator + log-softmax + stats + per-row top-k.

    x: [N, D] (cast to w.dtype); w: [V1, D]; b: [V1].  Returns (top_lsm
    [N, k] f32, top_ix [N, k] int64, row_sum [N] f32, ent [N] f32).
    CPU tensors take the plain twin; CUDA tensors launch the kernel, and
    operands it refuses raise.

    Shard mode: w and b are the columns [v_off, v_off + w.shape[0]) of a
    vocab of ``V1``, ``unk_idx`` a global index; ``parts_only`` returns
    the shard's workspace (wf [P, N, 5 + k] float32, wi [P, N, k] int32)
    for ``logit_topk_merge_parts``.
    """
    rows, D = w.shape
    V1 = rows if V1 is None else V1
    if not 1 <= k <= min(MAX_K, V1):
        raise ValueError('logit_topk: k=%d outside 1..%d' % (k, MAX_K))
    if not -1 <= unk_idx < V1:
        raise ValueError('logit_topk: unk_idx=%d outside -1..V1-1' % unk_idx)
    if not 0 <= v_off <= V1 - rows:
        raise ValueError('logit_topk: columns [%d, %d) outside V1 %d'
                         % (v_off, v_off + rows, V1))
    if (v_off, rows) != (0, V1) and not parts_only:
        raise ValueError('logit_topk: a shard of the vocab returns its parts '
                         '(parts_only); logit_topk_merge_parts merges them')
    local_unk = unk_idx - v_off if v_off <= unk_idx < v_off + rows else -1
    if x.device.type == 'cpu':
        if parts_only:
            return logit_topk_parts_ref(x, w, b, temp, unk_bias, k=k,
                                        unk_idx=local_unk, v_off=v_off)
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
            or b.shape != (rows,)):
        raise ValueError('logit_topk: needs CUDA x [N, D], contiguous w '
                         '[V1, D] and b [V1] on one device')
    lib = _build.load('logit_topk')
    sms = _sm_count(x.device.index)
    if bf16:
        splits, _ = plan_splits(N, rows, bf16_rows(D), BF16_TILE, sms)
        parts = 2 * splits          # one per consumer warpgroup
    else:
        splits, _ = plan_splits(N, rows, F32_ROWS, F32_TILE, sms,
                                blocks_per_sm=2)
        parts = splits
    f32 = dict(dtype=torch.float32, device=x.device)
    ws_f = torch.empty(parts, N, 5 + k, **f32)
    ws_i = torch.empty(parts, N, k, dtype=torch.int32, device=x.device)
    if parts_only:
        rc = lib.logit_topk(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), ws_f.data_ptr(),
            ws_i.data_ptr(), 0, 0, 0, 0, N, D, rows, k, local_unk, splits,
            v_off, 0, float(temp), float(unk_bias),
            _build.dtype_code(w.dtype), _build.stream_ptr(x.device))
        _build.check(rc, 'logit_topk')
        _build.count_launch(logit_topk)
        return ws_f, ws_i
    vals = torch.empty(N, k, **f32)
    idx = torch.empty(N, k, dtype=torch.int32, device=x.device)
    row_sum = torch.empty(N, **f32)
    ent = torch.empty(N, **f32)
    rc = lib.logit_topk(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), ws_f.data_ptr(),
        ws_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), row_sum.data_ptr(),
        ent.data_ptr(), N, D, V1, k, unk_idx, splits, 0, 1, float(temp),
        float(unk_bias), _build.dtype_code(w.dtype),
        _build.stream_ptr(x.device))
    _build.check(rc, 'logit_topk')
    _build.count_launch(logit_topk)
    return vals, idx.long(), row_sum, ent


def logit_topk_merge_parts(wf, wi, *, V1: int, k: int):
    """The merge of B2's parts gathered from the shards of a vocab of
    ``V1`` (wf [P, N, 5 + k], wi [P, N, k] int32 with global indices):
    (top_lsm [N, k], top_ix [N, k] int64, row_sum [N], ent [N]) as
    ``logit_topk`` returns them.  CPU tensors take the plain twin; CUDA
    tensors launch the merge kernel."""
    P, N, width = wf.shape
    if width != 5 + k or wi.shape != (P, N, k) or not 1 <= k <= MAX_K:
        raise ValueError('logit_topk_merge_parts: wf [P, N, 5 + k] and wi '
                         '[P, N, k], k <= %d' % MAX_K)
    if wf.device.type == 'cpu':
        return logit_topk_merge_ref(wf, wi, V1, k)
    if not wf.is_cuda or wi.device != wf.device or wf.dtype != \
            torch.float32 or wi.dtype != torch.int32:
        raise ValueError('logit_topk_merge_parts: needs CUDA float32 wf and '
                         'int32 wi on one device')
    wf, wi = wf.contiguous(), wi.contiguous()
    f32 = dict(dtype=torch.float32, device=wf.device)
    vals = torch.empty(N, k, **f32)
    idx = torch.empty(N, k, dtype=torch.int32, device=wf.device)
    row_sum = torch.empty(N, **f32)
    ent = torch.empty(N, **f32)
    rc = _build.load('logit_topk').logit_topk_merge_parts(
        wf.data_ptr(), wi.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        row_sum.data_ptr(), ent.data_ptr(), N, V1, k, P,
        _build.stream_ptr(wf.device))
    _build.check(rc, 'logit_topk_merge_parts')
    _build.count_launch(logit_topk_merge_parts)
    return vals, idx.long(), row_sum, ent


def logit_topk_sharded(x, w, b, group, temp=1.0, unk_bias=0.0, *, k: int,
                       unk_idx: int = -1, v_off: int, V1: int):
    """B2 over a vocab sharded on a model group: this rank's parts
    (``logit_topk(parts_only=True)``; w [V1 / M, D] and b [V1 / M], its
    columns from ``v_off``), all-gathered over ``group`` in rank order
    (P parts a rank, the same on every rank), then merged with the global
    ``V1``.  Every rank of the group gets the same result, which
    ``logit_topk`` would give over the whole vocab."""
    if b.is_cuda and b.data_ptr() % 16:
        b = b.clone()          # a slice of the bias at an odd offset
    wf, wi = logit_topk(x, w, b, temp, unk_bias, k=k, unk_idx=unk_idx,
                        v_off=v_off, V1=V1, parts_only=True)
    size = dist.get_world_size(group)
    parts_f = [torch.empty_like(wf) for _ in range(size)]
    parts_i = [torch.empty_like(wi) for _ in range(size)]
    dist.all_gather(parts_f, wf.contiguous(), group=group)
    dist.all_gather(parts_i, wi.contiguous(), group=group)
    return logit_topk_merge_parts(torch.cat(parts_f), torch.cat(parts_i),
                                  V1=V1, k=k)


_build.counted(logit_topk)
_build.counted(logit_topk_merge_parts)
