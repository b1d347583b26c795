"""The model axis's vocab-parallel pieces (the JAX package's vocab-dim
tensor parallelism of ``logit/kernel``, ``generator/kernel`` and
``tgt_embed``, ``captioning_tpu/parallel/mesh.py:param_sharding_spec``).

The M ranks of a model group read the same rows.  Rank m holds the rows
[m V1 / M, (m + 1) V1 / M) of a vocab tensor (``VocabShard``); each
piece below is a ``torch.autograd.Function`` over the model group, so
that the gradients are those of one process:

* ``copy_to_model``: identity forward; the backward sums the ranks'
  input gradients (each rank's product saw the whole input);
* ``gather_from_model``: the ranks' [..., V1 / M] outputs all-gathered
  into [..., V1] forward; the backward keeps this rank's columns;
* ``slice_replicated``: this rank's slice of a replicated [V1] bias
  forward; the backward all-gathers the slices' gradients, so every rank
  holds the bias's whole gradient (the biases stay replicated, as in the
  JAX rule);
* ``reduce_from_model``: the ranks' partial lookups summed forward; the
  backward is the identity.

``VocabParallelLinear`` (copy, the local [V1 / M, H] product with its
slice of the bias, gather) returns the full [N, V1] logits, so every
consumer downstream stays as it is; ``VocabShard.embed`` looks up the
ids of the rank's own range, zeros the rest and sums over the group.
Both read the bf16 compute copies where the captioner has them
(``models.layers.compute_param``).  Collectives move tensors of another
dtype than float32 as float32 (exact: a cast there and back, a sum of one
non-zero term), which every backend reduces.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import compute_param


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """This rank's rows [offset, offset + rows) of a vocab of ``V1``, the
    ``index``-th of ``size`` shards over the model ``group``."""
    group: Any
    index: int
    size: int
    V1: int

    @property
    def rows(self) -> int:
        return self.V1 // self.size

    @property
    def offset(self) -> int:
        return self.index * self.rows

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The rows of the whole [V1, D] table at ``ids`` from this rank's
        shard ``table`` [V1 / M, D]: its own ids looked up, the others
        zero, summed over the group."""
        local = ids - self.offset
        inside = (local >= 0) & (local < self.rows)
        found = table[local.clamp(0, self.rows - 1)]
        found = torch.where(inside[..., None], found, found.new_zeros(()))
        return reduce_from_model(found, self.group)


def _as_f32(x):
    return x if x.dtype == torch.float32 else x.float()


def _all_reduce(x, group):
    y = _as_f32(x).contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _all_gather(x, group, dim):
    y = _as_f32(x).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return _all_gather(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank(ctx.group) * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, shard):
        ctx.shard = shard
        return b[shard.offset:shard.offset + shard.rows]

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.shard.group, 0), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def gather_from_model(x, group):
    return _GatherFromModel.apply(x, group)


def slice_replicated(b, shard: VocabShard):
    return _SliceReplicated.apply(b, shard)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


class VocabParallelLinear(nn.Linear):
    """An ``nn.Linear`` [V1, H] whose weight is this rank's [V1 / M, H]
    shard and whose bias stays the replicated [V1]: ``models.layers.linear``
    calls it, and it returns the full [..., V1] output."""

    # what models.layers.linear and the decode's step_topk look for
    vocab_parallel = True

    def __init__(self, lin: nn.Linear, shard: VocabShard):
        super().__init__(lin.in_features, shard.rows, bias=False,
                         device='meta')
        rows = slice(shard.offset, shard.offset + shard.rows)
        self.weight = nn.Parameter(lin.weight.detach()[rows].clone(),
                                   requires_grad=lin.weight.requires_grad)
        self.bias = lin.bias
        self.shard = shard

    def forward(self, x):
        w = compute_param(self, 'weight')
        b = slice_replicated(compute_param(self, 'bias'), self.shard)
        y = F.linear(copy_to_model(x, self.shard.group).to(w.dtype), w, b)
        return gather_from_model(y, self.shard.group)
