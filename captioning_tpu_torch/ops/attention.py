"""Additive attention of the RNN captioners: scores, masked softmax and the
weighted feature sum in one pass.

Replaces the TPU kernel ``captioning_tpu/ops/attention.py:_attn_kernel``
(wrapper ``additive_attention_fused``).  Semantics, for query row r of
block b = r // bw (bw = N // nb query rows share one attention row)::

    e[r, m] = sum_a tanh(p_att[b, m, a] + att_h[r, a]) * w_alpha[a] + b_alpha
    weight  = softmax_m(e[r]) * mask[b];  weight /= max(sum(weight), 1e-9)
    out[r]  = sum_m weight[m] * att_feats[b, m, :]

What bounds it on the H100: bytes.  At the UpDown beam-5 step (nb = 1024
images, bw = 5, M = 36, H = 1000, A = 512, bf16) the inputs are 111 MB of
att + p_att; the arithmetic is bw * M * A = 92 k tanh per image.  The TPU
kernel needed lane-replicated rows (bw = 1), so block-shared beam rows took
the jnp path, and it tiled 8 batch rows per grid step because Mosaic could
not lower the contractions.  ``csrc/additive_attention.cu`` gives one block
to each attention row and its bw queries: p_att[b] and att[b] are read
once per image, not once per beam lane, and the [bw, M] scores and weights
stay in shared memory.  M up to ``MAX_M``, bw up to ``MAX_BW`` and any H
and A work (the flagship's H = 1000 is no multiple of 32), as long as the
block's shared memory, (bw*A + A + bw*M) floats, stays within 48 KiB.

Element types: att_h, p_att_feats, w_alpha and b_alpha share one (float32
or bf16); att_feats and the output have that type too, or float32 with
bf16 queries (a bf16 model with ``use_bn == 2`` hands the head float32
features from its BatchNorm, as the JAX model does).

Rounding: the twin mirrors the Pallas body in the compute dtype (in bf16:
the add, tanh and the product with w rounded to bf16, the score sum, the
softmax and the renormalisation in float32, the weight and its product
with att rounded to bf16, the weighted sum accumulated in float32); the
kernel rounds at the same places, so the two differ in summation order
only.
"""

from __future__ import annotations

import torch

from . import _build

MAX_BW = 8
MAX_M = 1024
_SMEM = 48 * 1024


def additive_attention_ref(att_h, att_feats, p_att_feats, att_masks,
                           w_alpha, b_alpha):
    """Plain twin: the JAX ``additive_attention_ref`` extended to
    block-shared rows.  att_h [N, A]; att_feats [nb, M, H]; p_att_feats
    [nb, M, A]; att_masks [nb, M] or None; w_alpha [A]; b_alpha [1] or a
    scalar tensor.  N = nb * bw.  Returns [N, H] in att_feats' dtype."""
    nb, M, H = att_feats.shape
    A = att_h.shape[-1]
    bw = att_h.shape[0] // nb
    dot = torch.tanh(p_att_feats[:, None] + att_h.view(nb, bw, 1, A))
    e = (dot * w_alpha).float().sum(-1) + b_alpha.float().reshape(())
    weight = torch.softmax(e, dim=-1)                       # [nb, bw, M]
    if att_masks is not None:
        weight = weight * att_masks[:, None].float()
        weight = weight / weight.sum(-1, keepdim=True).clamp_min(1e-9)
    wt = weight.to(att_feats.dtype)
    out = (att_feats[:, None] * wt[..., None]).sum(2)       # [nb, bw, H]
    return out.reshape(nb * bw, H)


def _check(att_h, att_feats, p_att_feats, mask, w_alpha, b_alpha):
    if att_feats.dim() != 3 or p_att_feats.dim() != 3 or att_h.dim() != 2:
        raise ValueError('additive_attention_fused: att_h [N, A], att_feats '
                         '[nb, M, H], p_att_feats [nb, M, A]')
    nb, M, H = att_feats.shape
    N, A = att_h.shape
    if (nb == 0 or N % nb or tuple(p_att_feats.shape) != (nb, M, A)
            or tuple(mask.shape) != (nb, M) or w_alpha.numel() != A
            or b_alpha.numel() != 1):
        raise ValueError('additive_attention_fused: shapes att_h %s, '
                         'att_feats %s, p_att_feats %s, mask %s, w %s, b %s'
                         % tuple(tuple(x.shape) for x in (
                             att_h, att_feats, p_att_feats, mask, w_alpha,
                             b_alpha)))
    bw = N // nb
    smem = 4 * (bw * A + A + bw * M)
    if bw > MAX_BW or M > MAX_M or smem > _SMEM:
        raise ValueError('additive_attention_fused: bw=%d (max %d), M=%d '
                         '(max %d), shared memory %d B (max %d)'
                         % (bw, MAX_BW, M, MAX_M, smem, _SMEM))
    return nb, bw, M, H, A


def additive_attention_fused(att_h, att_feats, p_att_feats, att_masks,
                             w_alpha, b_alpha):
    """Fused additive attention, row-aligned (nb == N) or block-shared
    (nb divides N).  ``att_masks`` None means every region is valid (the
    kernel always takes a mask; renormalising by ones changes values by
    rounding only).  CPU tensors take the plain twin; CUDA tensors launch
    the kernel."""
    if att_masks is None:
        att_masks = torch.ones(att_feats.shape[:2], dtype=torch.float32,
                               device=att_feats.device)
    nb, bw, M, H, A = _check(att_h, att_feats, p_att_feats, att_masks,
                             w_alpha, b_alpha)
    if att_h.device.type == 'cpu':
        return additive_attention_ref(att_h, att_feats, p_att_feats,
                                      att_masks, w_alpha, b_alpha)
    mask = att_masks.float().contiguous()
    tensors = [att_h, att_feats, p_att_feats, w_alpha, b_alpha]
    if (not att_h.is_cuda
            or any(x.device != att_h.device for x in tensors + [mask])
            or any(x.dtype != att_h.dtype for x in tensors
                   if x is not att_feats)
            or att_feats.dtype not in (att_h.dtype, torch.float32)
            or not all(x.is_contiguous() for x in tensors)):
        raise ValueError('additive_attention_fused: needs contiguous CUDA '
                         'tensors on one device, of one dtype (att_feats '
                         'may be float32)')
    lib = _build.load('additive_attention')
    out = torch.empty(nb * bw, H, dtype=att_feats.dtype,
                      device=att_feats.device)
    rc = lib.additive_attention(
        att_h.data_ptr(), att_feats.data_ptr(), p_att_feats.data_ptr(),
        mask.data_ptr(), w_alpha.data_ptr(), b_alpha.data_ptr(),
        out.data_ptr(), nb, bw, M, H, A, _build.dtype_code(att_h.dtype),
        _build.dtype_code(att_feats.dtype), _build.stream_ptr(att_h.device))
    _build.check(rc, 'additive_attention_fused')
    additive_attention_fused.launches += 1
    return out


additive_attention_fused.launches = 0
