"""Exact top-k over the last dimension (the beam search's candidate
selection).

Replaces the TPU kernel ``captioning_tpu/ops/topk.py:_topk_kernel``
(wrapper ``topk_lastdim``): ``lax.top_k`` of a float32 [B, C] table, values
descending, equal values by ascending index, -inf entries and all--inf rows
included.  The plain beam route (``engine/decoding.py``) selects each
step's survivors with it from the ``[B, bdash * V1]`` candidate table.

What bounds it on the H100: bytes (the table, 194 MB at B = 1024, bdash 5,
V1 = 9488).  ``csrc/topk.cu`` reads it once, one block per row, each thread
keeping a register top-k of its strided slice behind a block-shared
threshold (the k-th best of the row's first 4096 elements), and merges the
threads' lists in k block-wide rounds.

The twin ``top_k`` is a stable descending sort, which keeps equal values in
index order; the kernel's results are bit-identical to it.
"""

from __future__ import annotations

import torch

from . import _build

MAX_K = 16


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: values descending, ties resolved to
    the lowest index (a stable descending sort keeps equal values in index
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_lastdim(x, k: int):
    """Top-k of each row of x [B, C], cast to float32 as the JAX wrapper
    casts; x must be contiguous and 1 <= k <= min(16, C).  Returns (values
    [B, k] float32, indices [B, k] int64).  CPU tensors take the twin; CUDA
    tensors launch the kernel."""
    if x.dim() != 2 or not 1 <= k <= min(MAX_K, x.shape[1]):
        raise ValueError('topk_lastdim: x [B, C] and 1 <= k <= min(%d, C), '
                         'got x %s, k=%d' % (MAX_K, tuple(x.shape), k))
    if not x.is_contiguous():
        raise ValueError('topk_lastdim: x must be contiguous')
    x = x.float()
    if x.device.type == 'cpu':
        return top_k(x, k)
    if not x.is_cuda:
        raise ValueError('topk_lastdim: needs a CUDA tensor')
    B, C = x.shape
    lib = _build.load('topk')
    vals = torch.empty(B, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(B, k, dtype=torch.int64, device=x.device)
    rc = lib.topk_lastdim(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), B,
                          C, k, _build.stream_ptr(x.device))
    _build.check(rc, 'topk_lastdim')
    _build.count_launch(topk_lastdim)
    return vals, idx


_build.counted(topk_lastdim)
