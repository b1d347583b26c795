"""Shared building blocks (port of ``captioning_tpu/models/layers.py``).

Init semantics follow the JAX package, which follows torch's defaults:
``Dense`` kernels and biases are U(+-1/sqrt(fan_in)), ``Embedding`` tables
N(0, 1).  Parameters are float32 and stay so: they are the master weights
that the optimizer steps and the checkpoint holds.  At a compute dtype
other than float32 (``cfg.dtype``), ``install_compute_copies`` gives each
Linear and Embedding parameter a copy in that dtype (a non-persistent
buffer), and ``compute_param`` hands a use that copy, as the JAX ``Dense``
and ``Embedding`` cast their float32 params to the compute dtype at every
use.  In a pass that differentiates, the use goes through ``CastUse``:
its backward casts the use's gradient to float32, so the uses of a weight
sum in float32, as the transpose of each JAX ``astype`` does.  The copies
are refreshed in place from the masters (``sync_compute_copies``) after
each optimizer step, so a CUDA graph that read them reads the new
weights.

Train mode is an explicit ``torch.Generator`` (``gen``), as the JAX modules
take ``train`` and a dropout rng: ``None`` runs the eval branch (no
dropout, the BatchNorm's running statistics).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def init_dense(lin: nn.Linear, generator: torch.Generator):
    """``layers.Dense`` default init: kernel and bias U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(max(lin.in_features, 1))
    uniform_(lin.weight, bound, generator)
    if lin.bias is not None:
        uniform_(lin.bias, bound, generator)


class CastUse(torch.autograd.Function):
    """One use of a float32 master through its compute-dtype copy: the
    forward hands out the copy (a view: no kernel), the backward returns
    this use's gradient cast to float32 for the master, where autograd
    sums it with the other uses' (the JAX ``astype`` transposes to a cast
    back at each use, and a scan sums the steps in float32)."""

    @staticmethod
    def forward(ctx, master, copy):
        return copy.view_as(copy)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.float32), None


def compute_param(module: nn.Module, name: str) -> torch.Tensor:
    """The parameter ``name`` of ``module`` as a use computes with it: its
    compute-dtype copy where ``install_compute_copies`` made one (through
    ``CastUse`` when the pass differentiates the master), else the float32
    parameter itself."""
    p = getattr(module, name)
    copy = module._buffers.get(name + '_c')
    if copy is None:
        return p
    if p.requires_grad and torch.is_grad_enabled():
        return CastUse.apply(p, copy)
    return copy


def install_compute_copies(module: nn.Module, dtype: torch.dtype, kinds,
                           extra=()):
    """Give every parameter of the submodules of the types ``kinds``, and
    the parameters named in ``extra`` of ``module`` itself, a copy in
    ``dtype``, a non-persistent buffer ``<name>_c`` beside it (float32
    installs nothing: the parameters are the compute weights).  Returns
    the (master, copy) pairs that ``sync_compute_copies`` refreshes."""
    if dtype == torch.float32:
        return []
    owners = [(m, n) for m in module.modules() if isinstance(m, kinds)
              for n, _ in m.named_parameters(recurse=False)]
    owners += [(module, n) for n in extra]
    pairs = []
    for m, n in owners:
        p = getattr(m, n)
        copy = p.detach().to(dtype)
        m.register_buffer(n + '_c', copy, persistent=False)
        pairs.append((p, copy))
    return pairs


@torch.no_grad()
def sync_compute_copies(pairs) -> None:
    """Each copy rewritten in place from its master: one cast a
    parameter, at the copy's fixed address."""
    if pairs:
        torch._foreach_copy_([c for _, c in pairs], [p for p, _ in pairs])


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``layers.Dense`` compute: the input, the kernel and the bias in the
    compute dtype (the weight's copy, made in ``cfg.dtype``)."""
    w = compute_param(lin, 'weight')
    b = None if lin.bias is None else compute_param(lin, 'bias')
    return F.linear(x.to(w.dtype), w, b)


class Embedding(nn.Module):
    """``layers.Embedding``: an N(0, 1) table looked up by id."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            self.embedding.normal_(generator=generator)

    def forward(self, ids):
        # cast, then gather: a repeated id's gradient rows sum in the
        # compute dtype before the cast back, as the JAX ``jnp.take`` of
        # the cast table
        return compute_param(self, 'embedding')[ids]


def dropout(x, p: float, gen: Optional[torch.Generator]):
    """``layers.Dropout``: in train mode (``gen`` given) and at p > 0 each
    element is kept with probability 1 - p and scaled by 1 / (1 - p); the
    mask is ``torch.rand`` on x's device drawn from ``gen`` (F.dropout takes
    no generator).  Identity in eval or at p 0, drawing nothing."""
    if gen is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MLPEmbed(nn.Module):
    """Linear -> ReLU -> Dropout(drop); the att_embed pattern (reference
    AttModel.py:74-85)."""

    def __init__(self, in_features: int, features: int, drop: float = 0.0):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.drop = drop

    def init_weights(self, generator: torch.Generator):
        init_dense(self.Dense_0, generator)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        return dropout(torch.relu(linear(x, self.Dense_0)), self.drop, gen)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over ragged att features (use_bn).  Train mode
    normalises with the statistics of the valid (mask 1) positions and
    folds them into the running ones (momentum 0.9; the unbiased variance,
    as torch's BatchNorm1d accumulates it), in place and outside the
    autograd graph; eval mode normalises with the running ones."""

    momentum = 0.9

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('mean', torch.zeros(c))
        self.register_buffer('var', torch.ones(c))

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                train: bool = False):
        if train:
            if mask is None:
                # a fill, not a copy from the host: a graph holds it
                n = torch.full((), float(x.shape[0] * x.shape[1]),
                               device=x.device)
                mean = x.mean((0, 1))
                var = x.var((0, 1), unbiased=False)
            else:
                m = mask[..., None].to(x.dtype)
                n = m.sum().clamp_min(1.0)
                mean = (x * m).sum((0, 1)) / n
                var = (((x - mean) ** 2) * m).sum((0, 1)) / n
            with torch.no_grad():
                unbiased = var * (n / (n - 1.0).clamp_min(1.0))
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale + self.bias


def additive_attention(h, att_feats, p_att_feats, att_masks,
                       h2att: nn.Linear, alpha_net: nn.Linear):
    """The JAX ``layers.additive_attention`` (reference AttModel.py:719-748):
    h [N, H] queries; att_feats [nb, M, H]; p_att_feats [nb, M, A];
    att_masks [nb, M] or None (then no renormalisation).  nb == N is the
    row-aligned branch; otherwise bw = N // nb consecutive query rows share
    one attention row (block-shared beam lanes)."""
    N = h.shape[0]
    nb, M, H = att_feats.shape
    bw = N // nb
    att_h = linear(h, h2att).view(nb, bw, 1, -1)          # [nb, bw, 1, A]
    dot = torch.tanh(p_att_feats[:, None] + att_h)        # [nb, bw, M, A]
    e = linear(dot, alpha_net)[..., 0]                    # [nb, bw, M]
    weight = torch.softmax(e, dim=-1)
    if att_masks is not None:
        weight = weight * att_masks[:, None]
        weight = weight / weight.sum(-1, keepdim=True).clamp_min(1e-9)
    dt = torch.promote_types(weight.dtype, att_feats.dtype)
    att_res = torch.einsum('bqm,bmh->bqh', weight.to(dt), att_feats.to(dt))
    return att_res.reshape(N, H)
