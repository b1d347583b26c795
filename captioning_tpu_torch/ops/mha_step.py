"""Decode-step multi-head attention over a head-major KV cache, with the
step's K/V write.

Replaces the TPU kernel ``captioning_tpu/ops/mha_step.py:_mha_kernel``
(wrapper ``mha_step_fused``): write ``k_new``/``v_new`` into the caches
at time ``t``, then each row attends, per head, over its own entries at
times ``j <= t`` (no ancestry).  The JAX kernel aliases the caches to its
outputs; here they are written in place, and the wrapper returns the same
tensor objects it was given, so ``(out, k_cache, v_cache)`` keeps the JAX
signature.

What bounds it on the H100: bytes (t + 1 entries of K and V per row and
head, ~4 operations a byte).  The kernel is the strided attend of
``csrc/attend.cu`` (a warp per row serving its heads, every load of a
chunk in flight, online float32 softmax; see there): the caches'
[N, h, T, dk] layout is only its strides.

Rounding: the kernel keeps the scores and the probabilities in float32, as
the Pallas body does (``_mha_kernel``); the twin, like the JAX
``mha_step_ref``, rounds the product, the scaled scores and the
probabilities to the compute dtype.  In float32 both are exact up to
summation order.
"""

from __future__ import annotations

import torch

from . import _build
from .beam_attend import vector_bytes

_NEG_INF = -1e9


def mha_step_ref(q, k_new, v_new, k_cache, v_cache, t: int):
    """Plain twin: the JAX ``mha_step_ref`` op for op, with the cache write
    in place.  q/k_new/v_new: [N, h, dk]; caches [N, h, T, dk]."""
    T = k_cache.shape[-2]
    k_cache[:, :, t] = k_new
    v_cache[:, :, t] = v_new
    dk = q.shape[-1]
    scale = float(torch.tensor(float(dk), dtype=q.dtype).sqrt())
    s = torch.einsum('nhd,nhtd->nht', q, k_cache) / scale
    s = s.float().masked_fill(torch.arange(T, device=q.device) > t, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum('nht,nhtd->nhd', p, v_cache)
    return out, k_cache, v_cache


def mha_step_fused(q, k_new, v_new, k_cache, v_cache, t: int):
    """Write this step's K/V at time ``t`` (in place) and attend.

    q/k_new/v_new: [N, h, dk]; k_cache/v_cache: [N, h, T, dk]; t: the
    uniform step.  Returns ``(out [N, h, dk], k_cache, v_cache)``, the
    caches being the tensors passed in.  CPU tensors take the plain twin;
    CUDA tensors launch ``csrc/attend.cu``.
    """
    N, h, T, dk = k_cache.shape
    if not 0 <= t < T:
        raise ValueError('mha_step_fused: t=%d outside [0, %d)' % (t, T))
    for x in (q, k_new, v_new):
        if tuple(x.shape) != (N, h, dk):
            raise ValueError('mha_step_fused: q/k_new/v_new must be [N, h, '
                             'dk] = %s, got %s' % ((N, h, dk),
                                                   tuple(x.shape)))
    if tuple(v_cache.shape) != (N, h, T, dk):
        raise ValueError('mha_step_fused: v_cache %s != k_cache %s'
                         % (tuple(v_cache.shape), tuple(k_cache.shape)))
    if q.device.type == 'cpu':
        return mha_step_ref(q, k_new, v_new, k_cache, v_cache, t)
    tensors = [q, k_new, v_new, k_cache, v_cache]
    if (not q.is_cuda or any(x.device != q.device for x in tensors)
            or any(x.dtype != q.dtype for x in tensors)
            or not all(x.is_contiguous() for x in tensors)
            or dk % 2 or dk > 256):
        raise ValueError('mha_step_fused: needs contiguous CUDA tensors of '
                         'one dtype, even head width <= 256')
    _build.check_aligned('mha_step_fused',
                         vector_bytes(dk * q.element_size()), *tensors)
    lib = _build.load('attend')
    out = torch.empty_like(q)
    rc = lib.mha_step(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                      k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
                      N, h, T, dk, int(t), _build.dtype_code(q.dtype),
                      _build.stream_ptr(q.device))
    _build.check(rc, 'mha_step_fused')
    _build.count_launch(mha_step_fused)
    return out, k_cache, v_cache


_build.counted(mha_step_fused)
