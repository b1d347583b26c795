"""Fused decode-step self-attention over merged-lane caches, with the
step's K/V write, through a beam-ancestry table; and the attend alone.

Replaces the TPU kernel ``captioning_tpu/ops/beam_attend.py:_wa_kernel``
(wrapper ``attend_write_merged``).  Semantics: write ``k_new``/``v_new``
into the caches at row ``t0``; then each row r of a block of ``bw`` lanes
attends, per head, over the entries (time j <= t0) of the sibling slot
``anc[r, j]`` of its block; heads are merged in the output [N, D].

What bounds it on the H100: bytes.  A step reads, per row, t0 + 1 cache
rows of K and of V (D * 2 bytes each in bf16): at N = 5120, D = 512 and
t0 = 20 that is 220 MB per layer per step, against ~2 MFLOP of arithmetic
per row — far below the card's 295 FLOP/byte ridge.  The TPU kernel scored
all ``bw`` siblings and masked the others, reading bw * (t0 + 1) rows,
because it had no row gather.  ``csrc/beam_attend.cu`` gathers: one warp
per (row, head) reads only the ancestor's entry ``k[blk*bw + anc[r,j], j]``
per time step (T rows per lane, not bw * T).  It loads the row's ancestry
once per 32 steps, one 4-byte load a lane, hands the indices out by
shuffle, and issues every K and V load of a 16-step chunk (16-byte
vectors, 8 lanes to a 64-wide bf16 head entry) before it consumes any,
with a softmax in float32 so nothing but the context is written.  At
j == t0 the new entry comes from ``k_new``/``v_new`` (as ``_wa_kernel``
patches its slab) and is stored at ``[r, t0]``; ``anc[r, t0]`` is the
row's own slot, so no other row reads that entry in the same launch.
Any Tp works (the TPU kernel's semaphore array broke above Tp = 24).

Rounding: in bf16 the kernel rounds each scaled score to bf16 (as the TPU
kernel does) and keeps the softmax and the weighted sum in float32; the
twin rounds the scores to the compute dtype too but also rounds the
probabilities before the PV product.  In float32 both are exact up to
summation order.

``attend_merged`` is the attend without the write (the TPU kernel
``captioning_tpu/ops/beam_attend.py:_attend_kernel``, which only benches
call): any T, ``anc[r, t0]`` any sibling, ``anc`` None when bw == 1.  It
runs ``csrc/attend.cu`` (see there), the strided attend it shares with
``ops/mha_step.py`` and ``ops/anc_attend.py``.  In bf16 it rounds each
scaled score as above, divides by sqrt(dk) rounded to bf16 as the twin does
(the Pallas body multiplies by the float32 1/sqrt(dk)), and keeps p in
float32, where the Pallas body and the twin round p to bf16 before the PV
product (``beam_attend.py:146``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build

_NEG_INF = -1e9


@functools.lru_cache(maxsize=None)
def sqrt_in(n: int, dtype: torch.dtype) -> float:
    """sqrt(n) rounded to ``dtype``, as the JAX code computes
    ``jnp.sqrt(jnp.asarray(n, dtype))``; made once per (n, dtype), so a
    decode step reads no tensor on the host."""
    return float(torch.tensor(float(n), dtype=dtype).sqrt())


def attend_merged_ref(q, k, v, anc: Optional[torch.Tensor], t0: int, *,
                      bw: int, h: int):
    """Plain twin of the attend (no cache write): the JAX
    ``attend_merged_ref``.  q: [N, D]; k/v: [N, Tp, D]; anc: [N, Tp] int32
    (ignored when bw == 1)."""
    N, T, D = k.shape
    dk = D // h
    nb = N // bw
    q4 = q.reshape(nb, bw, h, dk)
    k5 = k.reshape(nb, bw, T, h, dk)
    v5 = v.reshape(nb, bw, T, h, dk)
    scores = torch.einsum('bqhd,bsthd->bqhst', q4, k5) / sqrt_in(dk, q.dtype)
    tmask = torch.arange(T, device=q.device) <= t0
    if bw > 1:
        sel = anc.reshape(nb, bw, 1, T) == torch.arange(
            bw, device=q.device).view(1, 1, bw, 1)             # [b,q,s,t]
        allowed = sel & tmask
    else:
        allowed = tmask.expand(nb, bw, bw, T)
    scores = scores.masked_fill(~allowed[:, :, None], _NEG_INF)
    p = torch.softmax(scores.reshape(nb, bw, h, bw * T).float(), dim=-1)
    p = p.to(q.dtype).reshape(nb, bw, h, bw, T)
    return torch.einsum('bqhst,bsthd->bqhd', p, v5).reshape(N, D)


def attend_write_merged_ref(q, k_cache, v_cache, k_new, v_new, anc, t0: int,
                            *, bw: int, h: int):
    """Plain twin of ``attend_write_merged``."""
    k_cache[:, t0] = k_new
    v_cache[:, t0] = v_new
    return attend_merged_ref(q, k_cache, v_cache, anc, t0, bw=bw, h=h)


def vector_bytes(head_bytes: int) -> int:
    """The width of ``attend_write_merged``'s loads: the widest of 16, 8
    and 4 bytes that divides a head's bytes."""
    return next(vb for vb in (16, 8, 4) if head_bytes % vb == 0)


def attend_write_merged(q, k_cache, v_cache, k_new, v_new,
                        anc: Optional[torch.Tensor], t0: int, *, bw: int,
                        h: int):
    """Write this step's K/V entry into the caches at ``t0`` (in place) and
    attend through the ancestry table.

    q/k_new/v_new: [N, D]; k_cache/v_cache: [N, Tp, D]; anc: [N, Tp] int32
    with values in [0, bw), or None when bw == 1 (each row its own block);
    t0: the uniform step, positions <= t0 valid.  Returns ctx [N, D].
    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    N, T, D = k_cache.shape
    if N % bw or D % h or not 0 <= t0 < T:
        raise ValueError('attend_write_merged: N=%d bw=%d D=%d h=%d t0=%d '
                         'Tp=%d' % (N, bw, D, h, t0, T))
    if bw > 1 and (anc is None or tuple(anc.shape) != (N, T)):
        raise ValueError('attend_write_merged: anc [N, Tp] needed for bw > 1')
    if q.device.type == 'cpu':
        return attend_write_merged_ref(q, k_cache, v_cache, k_new, v_new,
                                       anc, t0, bw=bw, h=h)
    dk = D // h
    tensors = [q, k_cache, v_cache, k_new, v_new]
    if (not q.is_cuda or any(x.device != q.device for x in tensors)
            or any(x.dtype != q.dtype for x in tensors)
            or not all(x.is_contiguous() for x in tensors)
            or q.shape != (N, D) or k_new.shape != (N, D)
            or v_new.shape != (N, D) or v_cache.shape != k_cache.shape
            or dk % 2 or dk > 256):
        raise ValueError('attend_write_merged: needs contiguous CUDA tensors '
                         'of one dtype, q/k_new/v_new [N, D], caches '
                         '[N, Tp, D], even head width <= 256')
    if bw > 1 and (anc.dtype != torch.int32 or anc.device != q.device
                   or not anc.is_contiguous()):
        raise ValueError('attend_write_merged: anc must be contiguous int32 '
                         'on the same device')
    _build.check_aligned('attend_write_merged',
                         vector_bytes(dk * q.element_size()), *tensors)
    lib = _build.load('beam_attend')
    ctx = torch.empty_like(q)
    rc = lib.attend_write_merged(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(),
        anc.data_ptr() if bw > 1 else None, ctx.data_ptr(),
        N, T, D, h, bw, int(t0), _build.dtype_code(q.dtype),
        _build.stream_ptr(q.device))
    _build.check(rc, 'attend_write_merged')
    _build.count_launch(attend_write_merged)
    return ctx


_build.counted(attend_write_merged)


def attend_merged(q, k, v, anc: Optional[torch.Tensor], t0: int, *, bw: int,
                  h: int):
    """Decode-step self-attention over merged-lane caches through the
    ancestry table, without a cache write.

    q: [N, D]; k/v: [N, T, D], any T; anc: [N, T] int32 with values in
    [0, bw), or None when bw == 1; t0: the uniform step, positions <= t0
    valid.  Returns ctx [N, D].  CPU tensors take the plain twin; CUDA
    tensors launch ``csrc/attend.cu``.
    """
    N, T, D = k.shape
    if N % bw or D % h or not 0 <= t0 < T:
        raise ValueError('attend_merged: N=%d bw=%d D=%d h=%d t0=%d T=%d'
                         % (N, bw, D, h, t0, T))
    if bw > 1 and (anc is None or tuple(anc.shape) != (N, T)):
        raise ValueError('attend_merged: anc [N, T] needed for bw > 1')
    if q.device.type == 'cpu':
        return attend_merged_ref(q, k, v, anc, t0, bw=bw, h=h)
    dk = D // h
    tensors = [q, k, v]
    if (not q.is_cuda or any(x.device != q.device for x in tensors)
            or any(x.dtype != q.dtype for x in tensors)
            or not all(x.is_contiguous() for x in tensors)
            or q.shape != (N, D) or v.shape != k.shape
            or dk % 2 or dk > 256):
        raise ValueError('attend_merged: needs contiguous CUDA tensors of one '
                         'dtype, q [N, D], caches [N, T, D], even head width '
                         '<= 256')
    if bw > 1 and (anc.dtype != torch.int32 or anc.device != q.device
                   or not anc.is_contiguous()):
        raise ValueError('attend_merged: anc must be contiguous int32 on the '
                         'same device')
    _build.check_aligned('attend_merged',
                         vector_bytes(dk * q.element_size()), *tensors)
    lib = _build.load('attend')
    ctx = torch.empty_like(q)
    rc = lib.attend_merged(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        anc.data_ptr() if bw > 1 else None, ctx.data_ptr(),
        N, T, D, h, bw, int(t0), _build.dtype_code(q.dtype),
        _build.stream_ptr(q.device))
    _build.check(rc, 'attend_merged')
    _build.count_launch(attend_merged)
    return ctx


_build.counted(attend_merged)
