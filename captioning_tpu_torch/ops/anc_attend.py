"""Beam ancestry attention over one layer of a stacked KV cache, read in
place.

Replaces the TPU kernel ``captioning_tpu/ops/anc_attend.py:_kernel``
(wrapper ``anc_attend``).  The caches are stacked over the decoder layers,
``[N, L, h, T, dk]``; the step attends over layer ``l``.  Taking
``K[:, l]`` first would copy the layer's whole cache (the copy the JAX
kernel exists to avoid, ``anc_attend.py:15-26``), so the kernel indexes
the layer by its stride: the strided attend of ``csrc/attend.cu``, a warp
per row serving its heads, which for each time ``j <= t`` gathers the
ancestor slot ``blk*bw + anc[r, j]`` of the row's block of ``bw`` rows
(the ancestry loaded once per 32 steps, every load of a chunk in flight)
and folds it into an online float32 softmax (see there).  It reads only
allowed entries, so it has nothing to mask.  q and the output are merged
``[N, h * dk]``.

What bounds it on the H100: bytes (the distinct ancestor entries of the
layer, ~4 operations a byte).

Rounding: the kernel keeps scores and probabilities in float32 and rounds
only its output.  The Pallas body keeps its scores in float32 too but
rounds the unnormalised weights to the compute dtype before the PV product
(``anc_attend.py:124``); the twin, like the JAX ``anc_attend_ref``, rounds
the product, the scaled scores and the probabilities to the compute dtype.  The twin masks the entries of other siblings and of times
after ``t`` with -1e9, whose weights are exactly 0 in float32.
"""

from __future__ import annotations

import torch

from . import _build
from .beam_attend import vector_bytes

_NEG_INF = -1e9


def anc_attend_ref(K, V, q, anc, l: int, t: int, bw: int):
    """Plain twin: the JAX ``anc_attend_ref`` op for op (layer slice, then
    the ancestry attend with a uniform time mask).

    K, V: [N, L, h, T, dk]; q: [N, h * dk]; anc: [N, T] int32; l, t: the
    layer and the step.  Returns [N, h * dk].
    """
    N, L, h, T, dk = K.shape
    k, v = K[:, l], V[:, l]
    nb = N // bw
    q4 = q.reshape(nb, bw, h, dk)
    k5 = k.reshape(nb, bw, h, T, dk)
    v5 = v.reshape(nb, bw, h, T, dk)
    scale = float(torch.tensor(float(dk), dtype=q.dtype).sqrt())
    scores = torch.einsum('bqhd,bshtd->bqhst', q4, k5) / scale
    sel = anc.reshape(nb, bw, 1, T) == torch.arange(
        bw, device=q.device).view(1, 1, bw, 1)                  # [b,q,s,t]
    allowed = sel & (torch.arange(T, device=q.device) <= t)
    scores = scores.masked_fill(~allowed[:, :, None], _NEG_INF)
    p = torch.softmax(scores.reshape(nb, bw, h, bw * T).float(), dim=-1)
    p = p.to(q.dtype).reshape(nb, bw, h, bw, T)
    out = torch.einsum('bqhst,bshtd->bqhd', p, v5)
    return out.reshape(N, h * dk)


def anc_attend(K, V, q, anc, l: int, t: int, bw: int):
    """Ancestry attend over layer ``l`` of the stacked caches, at step
    ``t``; args as ``anc_attend_ref``.  ``l`` and ``t`` are host ints,
    checked against L and T.  CPU tensors take the plain twin; CUDA tensors
    launch ``csrc/attend.cu``.
    """
    N, L, h, T, dk = K.shape
    if not (0 <= l < L and 0 <= t < T) or N % bw:
        raise ValueError('anc_attend: l=%d t=%d N=%d bw=%d for a cache of '
                         'L=%d T=%d' % (l, t, N, bw, L, T))
    if (tuple(V.shape) != tuple(K.shape) or tuple(q.shape) != (N, h * dk)
            or tuple(anc.shape) != (N, T)):
        raise ValueError('anc_attend: K/V [N, L, h, T, dk], q [N, h * dk], '
                         'anc [N, T]; got %s %s %s %s'
                         % (tuple(K.shape), tuple(V.shape), tuple(q.shape),
                            tuple(anc.shape)))
    if q.device.type == 'cpu':
        return anc_attend_ref(K, V, q, anc, l, t, bw)
    tensors = [K, V, q]
    if (not q.is_cuda or any(x.device != q.device for x in tensors + [anc])
            or any(x.dtype != q.dtype for x in tensors)
            or anc.dtype != torch.int32
            or not all(x.is_contiguous() for x in tensors + [anc])
            or dk % 2 or dk > 256):
        raise ValueError('anc_attend: needs contiguous CUDA tensors of one '
                         'dtype, anc int32, even head width <= 256')
    # the layer's offset l * h * T * dk elements keeps K's alignment
    _build.check_aligned('anc_attend', vector_bytes(dk * q.element_size()),
                         *tensors)
    lib = _build.load('attend')
    out = torch.empty_like(q)
    rc = lib.anc_attend(K.data_ptr(), V.data_ptr(), q.data_ptr(),
                        anc.data_ptr(), out.data_ptr(), N, L, h, T, dk,
                        int(l), int(t), bw, _build.dtype_code(q.dtype),
                        _build.stream_ptr(q.device))
    _build.check(rc, 'anc_attend')
    _build.count_launch(anc_attend)
    return out


_build.counted(anc_attend)
