"""Additive attention of the RNN captioners: scores, masked softmax and the
weighted feature sum in one pass.

Replaces the TPU kernel ``captioning_tpu/ops/attention.py:_attn_kernel``
(wrapper ``additive_attention_fused``).  Semantics, for query row r of
block b = r // bw (bw = N // nb query rows share one attention row)::

    e[r, m] = sum_a tanh(p_att[b, m, a] + att_h[r, a]) * w_alpha[a] + b_alpha
    weight  = softmax_m(e[r]) * mask[b];  weight /= max(sum(weight), 1e-9)
    out[r]  = sum_m weight[m] * att_feats[b, m, :]

What bounds it on the H100: bytes, and at bw 5 the tanh about as much.  At
the UpDown beam-5 step (nb = 1024 images, bw = 5, M = 36, H = 1000,
A = 512, bf16) the inputs are 111 MB of att + p_att; the arithmetic is
bw * M * A = 92 k tanh per image.  The TPU kernel needed lane-replicated
rows (bw = 1), so block-shared beam rows took the jnp path, and it tiled 8
batch rows per grid step because Mosaic could not lower the contractions.
``csrc/additive_attention.cu`` reads p_att[b] and att[b] once per image,
not once per beam lane, and keeps the [bw, M] scores and weights in shared
memory.  A persistent grid walks the images; where rows are whole
16-byte multiples a producer warp streams queries, p_att and att into a
shared-memory ring by bulk async copies, under the score work, and other
shapes take a direct kernel with vector or element loads; the bf16 tanh
is a shared-memory table (the source's header says more).
``launch_plan`` mirrors how it cuts the work.  M up to ``MAX_M``,
bw up to ``MAX_BW`` and any H and A work (the flagship's H = 1000 is no
multiple of 32), as long as the block's shared memory stays within the
card's 227 KB.

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
_SMEM = 232448                  # the most shared memory a block may take
_VEC = 8                        # elements a lane loads at a time
_SLICE_GROUPS = 32              # 8-element groups of A in a phase-1 unit
# the ring kernel: stages of 8 KB, as many as two blocks an SM leave room
# for (2 to 24), 4 columns a consumer thread
_STAGE = 8192
_RING_ROOM = 233472 // 2 - 1024
_RING_BARS = 512
_RING_MAX_H = 1024
# the bf16 tanh table covers the bits of |x| in [0x3D00, 0x4080): [2^-5, 4),
# 8 copies
TANH_TABLE = (0x3D00, 0x4080)
_TAB_BYTES = 2 * (TANH_TABLE[1] - TANH_TABLE[0]) * 8


def _size(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def smem_bytes(bw, M, A, dtype):
    """The direct kernel's shared memory for queries of ``dtype`` (the
    kernel every shape can take): the queries and w padded to 8 elements,
    the [bw, M] scores, the bf16 tanh table."""
    size = _size(dtype)
    return (size * (bw + 1) * -(-A // _VEC) * _VEC + 4 * bw * M
            + (_TAB_BYTES if size == 2 else 0))


def launch_plan(bw, M, H, A, dtype, att_dtype):
    """How ``csrc/additive_attention.cu`` cuts one image's work, mirrored
    for the tests, for 16-byte-aligned tensors: the kernel ('ring' where
    the rows are whole 16-byte multiples that fit a stage, A is a multiple
    of 8, H at most 1024 and its shared memory fits, else 'direct'), its
    shared memory, the phase-1 units (region m, A elements [a0, a1)) and,
    for the ring, its stages and the regions [m0, m1) of each p_att and att
    stage."""
    slice_len = _SLICE_GROUPS * _VEC
    units = [(m, a0, min(A, a0 + slice_len))
             for m in range(M) for a0 in range(0, A, slice_len)]
    prow, arow = _size(dtype) * A, _size(att_dtype) * H
    slices = -(-A // slice_len)
    rest = (_RING_BARS + _size(dtype) * (2 * bw + 1) * A
            + 4 * bw * M * (1 + slices)
            + (_TAB_BYTES if _size(dtype) == 2 else 0))
    stages = min(24, max(2, (_RING_ROOM - rest) // _STAGE))
    ring_smem = rest + stages * _STAGE
    if (A % _VEC == 0 and A > 0 and arow % 16 == 0 and 0 < H <= _RING_MAX_H
            and prow <= _STAGE and arow <= _STAGE and ring_smem <= _SMEM):
        rows_p, rows_a = _STAGE // prow, _STAGE // arow
        return {'kernel': 'ring', 'smem': ring_smem, 'stages': stages,
                'units': units,
                'p_stages': [(m, min(M, m + rows_p))
                             for m in range(0, M, rows_p)],
                'att_stages': [(m, min(M, m + rows_a))
                               for m in range(0, M, rows_a)]}
    return {'kernel': 'direct', 'smem': smem_bytes(bw, M, A, dtype),
            'units': units}


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
    smem = smem_bytes(bw, M, A, att_h.dtype)
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
    the kernel.

    Differentiable in every input but the mask (``AdditiveAttention``):
    the backward recomputes the plain twin under autograd and launches no
    kernel.  That is the JAX package's own design (the custom VJP of
    ``captioning_tpu/ops/attention.py:118-141`` recomputes through
    ``additive_attention_ref``; no Pallas kernel there has a backward), not
    a fallback: the forward on CUDA tensors is always the kernel."""
    if att_masks is None:
        att_masks = torch.ones(att_feats.shape[:2], dtype=torch.float32,
                               device=att_feats.device)
    args = (att_h, att_feats, p_att_feats, att_masks, w_alpha, b_alpha)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return AdditiveAttention.apply(*args)
    return _forward(*args)


class AdditiveAttention(torch.autograd.Function):
    """The kernel's forward with a backward by recompute through
    ``additive_attention_ref`` (the JAX custom VJP's ``_bwd``).  A row of
    ``alpha_net.weight`` passed as ``w_alpha`` gets its gradient through
    the view."""

    @staticmethod
    def forward(ctx, att_h, att_feats, p_att_feats, att_masks, w_alpha,
                b_alpha):
        ctx.save_for_backward(att_h, att_feats, p_att_feats, att_masks,
                              w_alpha, b_alpha)
        return _forward(att_h, att_feats, p_att_feats, att_masks, w_alpha,
                        b_alpha)

    @staticmethod
    def backward(ctx, grad):
        return recompute_grads(additive_attention_ref, ctx, (grad,))


def recompute_grads(ref, ctx, grads):
    """The gradients of ``ref`` at the saved inputs, recomputed under
    autograd, for the inputs that need one (None for the others)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(need)
              for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        outs = ref(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        want = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(outs, want, grads))
    return tuple(next(got) if x.requires_grad else None for x in xs)


def _forward(att_h, att_feats, p_att_feats, att_masks, w_alpha, b_alpha):
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
    _build.count_launch(additive_attention_fused)
    return out


additive_attention_fused.launches = 0


def tanh_table_rule(x):
    """The kernel's bf16 tanh (its table and bounds) on a bf16 tensor, for
    the check that it is ``round_bf16(tanhf(x))`` bit for bit: a CUDA
    tensor goes through the kernel's own rule, a CPU tensor through
    ``torch.tanh``."""
    if x.dtype != torch.bfloat16:
        raise TypeError('tanh_table_rule: bf16 only, got %s' % x.dtype)
    if x.device.type == 'cpu':
        return torch.tanh(x)
    if not x.is_cuda or not x.is_contiguous() or x.numel() == 0:
        raise ValueError('tanh_table_rule: needs a contiguous, non-empty '
                         'CUDA tensor')
    y = torch.empty_like(x)
    rc = _build.load('additive_attention').additive_attention_tanh(
        x.data_ptr(), y.data_ptr(), x.numel(), _build.stream_ptr(x.device))
    _build.check(rc, 'tanh_table_rule')
    return y
