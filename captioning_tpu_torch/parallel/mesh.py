"""The data and model axes over processes (port of ``captioning_tpu/parallel/mesh.py``).

The JAX package trains data-parallel under ``pjit``: the batch is sharded
on the mesh's ``data`` axis and the loss, its gradient, the BatchNorm
statistics and the val loss are computed on global arrays.  Here the axis
is a ``torch.distributed`` process group, one process a rank, and each
global quantity is built explicitly: every rank reads the same global
batch and keeps its ``local_batch_slice``; a loss divides by its
denominator (a mask sum, a count) summed over the ranks
(``all_reduce_sum``), so each rank's loss is its share of the global one;
one SUM all-reduce of a flat buffer sums the gradients (and the shares);
the BatchNorm sums go through ``all_reduce_grad``, whose backward sums
again.  The host side is the JAX package's: ``local_batch_slice`` and
``gather_predictions`` are copies, and ``object_allgather`` is the group's
``dist.all_gather_object``.

Backends (``choose_backend``, printed once a process): ``gloo`` on the
CPU; ``nccl`` where every rank of the host has a GPU of its own
(``cuda:LOCAL_RANK``); ``gloo`` over CUDA tensors where ranks share a card
(NCCL refuses two ranks on one device).  A backend that fails to
initialise raises; no other is tried.

The ``model`` axis is the JAX package's vocab-dim tensor parallelism:
``make_mesh("data:D,model:M")`` lays the D * M ranks out as the JAX
``make_mesh`` reshapes its devices, rank = d * M + m, and builds each data
group (the ranks of one m) and each model group (the ranks of one d).  The
M ranks of a model group read the same rows and hold the shards of the
vocab tensors that ``param_sharding_spec`` names (``parallel/vocab.py``,
``parallel/shard.py``); every mean over the batch is a sum over the data
group only, which ``local_batch_slice`` and the collectives' ``group``
arguments give the trainer and the eval.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes of this process: the group's world and this process's rank
    on it, the model axis's size and the process groups of this rank's
    data and model groups (None: the whole group, and no model group at
    model 1).  rank = data_index * model + model_index."""
    world: int
    rank: int
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


# the mesh that make_mesh built for the current process group
_MESH: Optional[Mesh] = None


def parse_mesh_shape(mesh_shape: str) -> List[Tuple[str, int]]:
    """"data:4,model:2" -> [('data', 4), ('model', 2)]."""
    axes = []
    for part in filter(None, (p.strip() for p in mesh_shape.split(','))):
        name, _, size = part.partition(':')
        name = name.strip()
        if name not in ('data', 'model') or not size.strip().isdigit() \
                or int(size) < 1:
            raise ValueError('mesh_shape %r: expected "data:N[,model:M]"'
                             % mesh_shape)
        axes.append((name, int(size)))
    return axes


def mesh_ranks(mesh_shape: str) -> int:
    """The ranks a mesh shape needs: data x model (0 when it names no
    axis)."""
    axes = dict(parse_mesh_shape(mesh_shape or ''))
    if not axes:
        return 0
    return axes.get('data', 1) * axes.get('model', 1)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def make_mesh(mesh_shape: str = '') -> Mesh:
    """The mesh over the process group (one rank, no group): the data axis
    defaults to world / model; data x model must equal the group's world.
    At model > 1 every rank builds the M data groups (one a model index)
    and the D model groups (one a data index) in the same order
    (``dist.new_group``) and keeps its own."""
    global _MESH
    world = world_size()
    axes = dict(parse_mesh_shape(mesh_shape or ''))
    model = axes.get('model', 1)
    data = axes.get('data', max(world // model, 1))
    if data * model != world:
        raise ValueError('mesh_shape %r: data %d x model %d needs %d ranks, '
                         'the process group has %d'
                         % (mesh_shape, data, model, data * model, world))
    data_group = model_group = None
    if model > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank() % model == m:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank() // model == d:
                model_group = g
    _MESH = Mesh(world, rank(), model, data_group, model_group)
    return _MESH


def current() -> Mesh:
    """The mesh ``make_mesh`` built for this process group, else the data
    axis over the whole group."""
    if _MESH is not None and dist.is_initialized() and \
            _MESH.world == world_size():
        return _MESH
    return Mesh(world_size(), rank())


def group_size(group=None) -> int:
    """The ranks of ``group`` (None: the whole group; 1 without one)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def local_batch_slice(global_batch_size: int, n_proc: int = None,
                      index: int = None) -> slice:
    """This rank's contiguous slice of the global batch over the data
    axis (the ranks of a model group take the same slice).  A remainder
    goes to the first ``rem`` ranks, so every global row belongs to
    exactly one data rank."""
    n_proc = current().data if n_proc is None else n_proc
    i = current().data_index if index is None else index
    per, rem = divmod(global_batch_size, n_proc)
    start = i * per + min(i, rem)
    return slice(start, start + per + (1 if i < rem else 0))


# the port's parameter names whose dim 0 is the vocab dim (nn.Linear
# weights [V1, in], the embedding [V1, D]): the JAX ``_VOCAB_OUT_PARAMS``
# (``logit/kernel``, ``generator/kernel`` [in, V1], ``tgt_embed``) by the
# weight bridge's names
_VOCAB_OUT_PARAMS = re.compile(r'(logit\.weight|generator\.weight|tgt_embed)$')


def param_sharding_spec(name: str, shape, model: int) -> Optional[int]:
    """The dim of the port's parameter ``name`` (shape ``shape``) that the
    model axis of size ``model`` shards, or None (replicated): the JAX
    ``param_sharding_spec`` on the port's names and nn.Linear layout.  The
    vocab tensors shard dim 0 where M divides it; the biases stay
    replicated."""
    if model > 1 and _VOCAB_OUT_PARAMS.search(name) and len(shape) > 1 \
            and shape[0] % model == 0:
        return 0
    return None


def choose_backend(device_type: str, local_rank: int, local_world: int,
                   n_gpus: int) -> Tuple[str, torch.device]:
    """(backend, this rank's device): gloo on the CPU; nccl with
    ``cuda:local_rank`` when each of the host's ``local_world`` ranks has
    a GPU of its own; gloo over ``cuda:local_rank % n_gpus`` when ranks
    share cards."""
    if device_type == 'cpu':
        return 'gloo', torch.device('cpu')
    if n_gpus < 1:
        raise RuntimeError('--device cuda: no CUDA device is available')
    if local_world <= n_gpus:
        return 'nccl', torch.device('cuda', local_rank)
    return 'gloo', torch.device('cuda', local_rank % n_gpus)


def init_distributed(opt, device='cuda') -> str:
    """Join the process group that ``opt`` names (the port of
    tools/train.py ``maybe_distributed_init``) and return this rank's
    device.  ``--dist_coordinator host:port`` with ``--dist_nproc`` and
    ``--dist_pid``; ``--dist_auto 1`` reads torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  Neither: one process, no group,
    ``device`` unchanged."""
    coord = getattr(opt, 'dist_coordinator', '') or ''
    if coord:
        world = int(getattr(opt, 'dist_nproc', -1))
        pid = int(getattr(opt, 'dist_pid', -1))
        if world < 1 or not 0 <= pid < world:
            raise ValueError('--dist_coordinator needs --dist_nproc N and '
                             '--dist_pid in [0, N), got %d and %d'
                             % (world, pid))
        init = 'tcp://' + coord
    elif int(getattr(opt, 'dist_auto', 0) or 0):
        env = os.environ
        missing = [k for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                               'MASTER_PORT') if k not in env]
        if missing:
            raise RuntimeError('--dist_auto 1: the environment lacks %s '
                               '(launch with torchrun)' % ', '.join(missing))
        world, pid = int(env['WORLD_SIZE']), int(env['RANK'])
        init = 'tcp://%s:%s' % (env['MASTER_ADDR'], env['MASTER_PORT'])
    else:
        return device
    local_rank = int(os.environ.get('LOCAL_RANK', pid))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    n_gpus = (torch.cuda.device_count() if torch.device(device).type ==
              'cuda' else 0)
    backend, dev = choose_backend(torch.device(device).type, local_rank,
                                  local_world, n_gpus)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=pid, timeout=TIMEOUT)
    print('distributed: rank %d of %d, backend %s, device %s'
          % (pid, world, backend, dev), flush=True)
    return str(dev)


def _collective_device() -> torch.device:
    """Where a host value crosses the group: the rank's card under nccl,
    the CPU under gloo."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (None: the whole group; a new tensor,
    no gradient), or ``x`` itself over one rank."""
    if group_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def global_mean(num: float, count: float, group=None) -> float:
    """sum(num) / sum(count) over ``group``: one all-reduce of the
    (numerator, count) pair."""
    if group_size(group) == 1:
        return num / count
    pair = torch.tensor([num, count], dtype=torch.float64,
                        device=_collective_device())
    dist.all_reduce(pair, group=group)
    return float(pair[0] / pair[1])


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group's ranks.  Every rank's loss reads
    the same y, so the global loss's gradient at y is the sum of the
    ranks' gradients: the backward sums too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce_sum`` that autograd differentiates (the BatchNorm's
    global sums); ``x`` itself over one rank."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def barrier() -> None:
    """Wait for every rank (a one-element all-reduce, on any backend)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1, device=_collective_device()))


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place (the JAX
    package's ``globalize_replicated``: the ranks start equal)."""
    if world_size() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def object_allgather(obj, allgather=None, group=None) -> list:
    """Every rank's ``obj`` (anything picklable) of ``group``, in rank
    order, on each of them: ``dist.all_gather_object``.  ``allgather(obj)``,
    a lockstep collective returning that list, stands in for the group."""
    if allgather is not None:
        return list(allgather(obj))
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def gather_predictions(predictions, _allgather=None, group=None):
    """Every rank of ``group`` gets the full concatenated list of the
    ranks' prediction lists, ordered by rank."""
    if _allgather is None and group_size(group) == 1:
        return predictions
    merged = []
    for chunk in object_allgather(predictions, _allgather, group):
        merged.extend(chunk)
    return merged


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0,
                               device=_collective_device())
    return box[0]
