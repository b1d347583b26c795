"""What the plain references share: the weights by their checkpoint name
(the ``model.npz`` layout: kernels [in, out], a transformer's layer
weights stacked on a leading axis), float32 arithmetic with TF32 off, and
the precision one step below the configurations' bfloat16 that the
control computes in.

Nothing here imports the program: the names are those of the checkpoint
format both sides read.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0          # the largest finite float8_e4m3fn


def no_tf32():
    """Float32 products in float32: TF32 would round them to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), returned in float32."""
    s = (x.abs().amax().float() / FP8_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Weights:
    """The checkpoint's tensors in float32 on one device; ``low`` is the
    control: every matrix product's operands, weights and activations,
    rounded by ``fp8``, one scale a tensor (a stacked layer's slice has
    its own), everything else float32."""

    def __init__(self, tensors, low: bool = False):
        self.low = low
        self.w = {}
        for name, t in tensors.items():
            t = t.float()
            if low and _is_matrix(name):
                t = (torch.stack([fp8(x) for x in t]) if t.dim() == 3
                     else fp8(t))
            self.w[name] = t

    def __getitem__(self, name):
        return self.w[name]

    def act(self, x):
        return fp8(x) if self.low else x

    def linear(self, x, kernel, bias=None):
        y = self.act(x) @ kernel
        return y if bias is None else y + bias


def _is_matrix(name: str) -> bool:
    """The tensors a product reads as its weight: kernels and embeddings
    (an embedding lookup is a product with a one-hot)."""
    return name.endswith(('kernel', 'embedding', 'tgt_embed'))


def layer_norm(x, a, b, eps: float = 1e-6):
    """The captioners' LayerNorm: the unbiased std, eps added to it."""
    mean = x.mean(-1, keepdim=True)
    std = x.std(-1, keepdim=True, unbiased=True)
    return a * (x - mean) / (std + eps) + b


def unk_adjust(lsm, unk_idx: int, unk_bias: float = -1000.0):
    """``suppress_UNK``: -1000 added to the UNK column after the
    log-softmax."""
    if unk_idx < 0:
        return lsm
    lsm = lsm.clone()
    lsm[..., unk_idx] += unk_bias
    return lsm


def entropy(lsm):
    return -(lsm.exp() * lsm).sum(-1)
