"""Shard and gather of a captioner's state on the model axis.

``shard_module`` swaps the vocab tensors of a full module, by
``mesh.param_sharding_spec``, for this rank's shards: an ``nn.Linear``
vocab projection (``logit``, ``generator``) becomes a
``vocab.VocabParallelLinear``, the transformer's ``tgt_embed`` its [V1 /
M, D] rows with a ``tgt_embed_shard`` that its lookup reads.  A vocab
tensor that M does not divide stays replicated, as in the JAX rule
(printed once); one the rule names on a module of another kind raises.

The checkpoint contract stays one process's: ``gather_state`` rebuilds
the full arrays on every rank of a model group (the model.npz and the
optimizer's moments that rank 0 writes), ``local_state`` cuts full arrays
(a ``--start_from`` checkpoint, its moments) into this rank's rows.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh, _VOCAB_OUT_PARAMS, param_sharding_spec
from .vocab import VocabParallelLinear, VocabShard

# the tensors already reported as staying replicated
_REPORTED = set()


def shard_module(module: nn.Module, mesh: Mesh) -> Dict[str, VocabShard]:
    """Swap ``module``'s vocab tensors for this rank's shards, in place;
    returns {parameter name: its shard}.  Nothing at model 1."""
    shards = {}
    if mesh.model == 1:
        return shards
    for name, p in list(module.named_parameters()):
        if not _VOCAB_OUT_PARAMS.search(name):
            continue
        if param_sharding_spec(name, tuple(p.shape), mesh.model) is None:
            if name not in _REPORTED:
                _REPORTED.add(name)
                print('model axis: %s %s stays replicated (model %d does '
                      'not divide its vocab dim)'
                      % (name, list(p.shape), mesh.model))
            continue
        shard = VocabShard(mesh.model_group, mesh.model_index, mesh.model,
                           p.shape[0])
        owner_name, _, attr = name.rpartition('.')
        owner = module.get_submodule(owner_name)
        if attr == 'weight' and isinstance(owner, nn.Linear):
            parent_name, _, child = owner_name.rpartition('.')
            setattr(module.get_submodule(parent_name), child,
                    VocabParallelLinear(owner, shard))
        elif attr == 'tgt_embed':
            rows = slice(shard.offset, shard.offset + shard.rows)
            setattr(owner, attr, nn.Parameter(
                p.detach()[rows].clone(), requires_grad=p.requires_grad))
            setattr(owner, attr + '_shard', shard)
        else:
            raise NotImplementedError(
                'model axis: %s on a %s is not sharded by the port (ROADMAP.md '
                'A7)' % (name, type(owner).__name__))
        shards[name] = shard
    return shards


def local_state(full: Dict[str, torch.Tensor],
                shards: Dict[str, VocabShard]) -> Dict[str, torch.Tensor]:
    """``full`` with each sharded entry cut to this rank's rows."""
    out = dict(full)
    for name, shard in shards.items():
        if name in out:
            out[name] = out[name][shard.offset:shard.offset + shard.rows]
    return out


def gather_state(local: Dict[str, torch.Tensor],
                 shards: Dict[str, VocabShard]) -> Dict[str, torch.Tensor]:
    """``local`` with each sharded entry all-gathered over its model group
    into the full [V1, ...] array (every rank of the group calls it, in
    the same order)."""
    out = dict(local)
    for name in sorted(shards):
        if name not in out:
            continue
        x = out[name].detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(shards[name].size)]
        dist.all_gather(parts, x, group=shards[name].group)
        out[name] = torch.cat(parts, 0)
    return out
