"""The model axis's host rules and B2's shard mode on the CPU:

* (a) the port's ``param_sharding_spec`` (``parallel/mesh.py``) against
  the JAX one over every ``caption_model`` key's parameters, with M 2 and
  4 and a vocab V1 of 30 (M 4 does not divide it: nothing shards) or 32:
  the port shards exactly the tensors whose JAX paths the JAX rule shards
  (a kernel [in, V1] on its dim 1 is the nn.Linear weight [V1, in] on its
  dim 0), and ``shard_module`` cuts them so;
* mesh shapes: the ranks a shape needs, and a one-rank group refusing a
  shape that needs more;
* (b) ``logit_topk_parts_ref`` over M shards then ``logit_topk_merge_ref``
  (the arithmetic of B2's shard mode) against ``logit_topk_ref`` on the
  whole vocab, M 2 and 4, k 1-16 (past a shard's width), ``unk_idx`` in
  each shard, temperature 0.8, exact ties across shards: indices
  identical, values, row_sum and entropy within 1e-5 (+1e-6 relative);
  the wrappers' argument checks, and CUDA-only paths that never take the
  twins."""

import jax
import numpy as np
import pytest
import torch

from captioning_tpu.parallel.mesh import make_mesh
from captioning_tpu.parallel.mesh import param_sharding_spec as jax_spec
from captioning_tpu_torch.ops import logit_topk as lt
from captioning_tpu_torch.parallel import mesh, shard
from captioning_tpu_torch.utils import weights
from tests.torch_port_util import RNN_MODELS, tiny_aoa_opt, tiny_opt, \
    tiny_rnn_opt

KEYS = ('transformer', 'bert', 'm2transformer', 'aoa') + RNN_MODELS
# the transformer's vocab tensors by their JAX paths (its other tensors
# are stacked by layer under other names)
TRANSFORMER_PATHS = {'generator.weight': 'params/generator/kernel',
                     'generator.bias': 'params/generator/bias',
                     'tgt_embed': 'params/tgt_embed'}


def _module(key, V1):
    from captioning_tpu_torch.models.api import setup
    kw = dict(vocab_size=V1 - 1)
    opt = (tiny_opt(caption_model=key, **kw)
           if key in ('transformer', 'bert', 'm2transformer') else
           tiny_aoa_opt(**kw) if key == 'aoa' else tiny_rnn_opt(key, **kw))
    cap = setup(opt, None, device='cpu')
    cap.init_params(torch.Generator().manual_seed(0))
    return cap


def _jax_path(key, name):
    if key == 'transformer':
        return TRANSFORMER_PATHS.get(name)
    return weights._jax_harness_key(name)


@pytest.mark.parametrize('V1', [30, 32])
@pytest.mark.parametrize('M', [2, 4])
@pytest.mark.parametrize('key', KEYS)
def test_sharding_rule_matches_jax(key, M, V1):
    cap = _module(key, V1)
    flat = weights.jax_from_state_dict(cap.module.state_dict(), cap.cfg)
    grid = make_mesh('data:1,model:%d' % M, jax.devices()[:M])
    jax_sharded = {}
    for path, value in flat.items():
        spec = jax_spec(path, grid, value.shape)
        if spec != jax.sharding.PartitionSpec():
            jax_sharded[path] = tuple(spec)
    port = {name: mesh.param_sharding_spec(name, tuple(p.shape), M)
            for name, p in cap.module.named_parameters()}
    port_sharded = {_jax_path(key, n) for n, d in port.items()
                    if d is not None}
    assert port_sharded == set(jax_sharded)
    for name, dim in port.items():
        if dim is not None:
            assert dim == 0
            path = _jax_path(key, name)
            assert jax_sharded[path] == (('model', None)
                                         if name.endswith('tgt_embed')
                                         else (None, 'model'))
    assert bool(port_sharded) == (V1 % M == 0)
    # shard_module cuts exactly those, as the model group's rank 1
    grid = mesh.Mesh(world=M, rank=1, model=M, model_group='group')
    shards = shard.shard_module(cap.module, grid)
    assert sorted(shards) == sorted(n for n, d in port.items()
                                    if d is not None)
    for name, sh in shards.items():
        assert (sh.offset, sh.rows, sh.V1) == (V1 // M, V1 // M, V1)
        assert dict(cap.module.named_parameters())[name].shape[0] == V1 // M


@pytest.mark.parametrize('shape,ranks', [
    ('', 0), ('data:3', 3), ('data:2,model:2', 4), ('model:4', 4),
    ('data:1,model:2', 2)])
def test_mesh_ranks(shape, ranks):
    assert mesh.mesh_ranks(shape) == ranks


@pytest.mark.parametrize('shape,need', [('model:2', 2), ('data:2,model:4', 8)])
def test_one_rank_refuses_a_model_axis(shape, need):
    with pytest.raises(ValueError, match='needs %d ranks' % need):
        mesh.make_mesh(shape)


def test_layout_of_the_mesh():
    m = mesh.Mesh(world=8, rank=5, model=2)
    assert (m.data, m.data_index, m.model_index) == (4, 2, 1)
    one = mesh.make_mesh('data:1,model:1')
    assert (one.data, one.model, one.data_index, one.model_index) == \
        (1, 1, 0, 0)


V1_B2, D_B2, N_B2 = 36, 12, 7


def _b2_inputs(seed, ties):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N_B2, D_B2, generator=g)
    w = torch.randn(V1_B2, D_B2, generator=g) * 0.7
    b = torch.randn(V1_B2, generator=g) * 0.1
    if ties:
        # the same column in different shards: a tie the lower index wins
        for lo, hi in ((2, 33), (10, 20), (17, 18)):
            w[hi], b[hi] = w[lo], b[lo]
    return x, w, b


def _sharded(x, w, b, M, k, unk_idx, temp, unk_bias):
    n = V1_B2 // M
    parts = [lt.logit_topk(x, w[m * n:(m + 1) * n], b[m * n:(m + 1) * n],
                           temp, unk_bias, k=k, unk_idx=unk_idx,
                           v_off=m * n, V1=V1_B2, parts_only=True)
             for m in range(M)]
    wf = torch.cat([p[0] for p in parts])
    wi = torch.cat([p[1] for p in parts])
    assert wf.shape == (M, N_B2, 5 + k) and wi.dtype == torch.int32
    return lt.logit_topk_merge_parts(wf, wi, V1=V1_B2, k=k)


@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('k', [1, 5, 12, 16])
@pytest.mark.parametrize('M', [2, 4])
def test_parts_and_merge_twins_equal_the_whole_vocab(M, k, ties):
    x, w, b = _b2_inputs(M * 100 + k, ties)
    n = V1_B2 // M
    # UNK in each shard in turn (and none), pushed down and up
    for unk_idx, unk_bias in [(-1, 0.0)] + [(m * n + 3, (-1) ** m * 2.0)
                                            for m in range(M)]:
        want = lt.logit_topk_ref(x, w, b, 0.8, unk_bias, k=k,
                                 unk_idx=unk_idx)
        got = _sharded(x, w, b, M, k, unk_idx, 0.8, unk_bias)
        assert torch.equal(got[1], want[1]), unk_idx
        for g, e in zip((got[0], got[2], got[3]),
                        (want[0], want[2], want[3])):
            np.testing.assert_allclose(g.numpy(), e.numpy(), atol=1e-5,
                                       rtol=1e-6, err_msg=str(unk_idx))


def test_shard_mode_arguments():
    x, w, b = _b2_inputs(0, False)
    with pytest.raises(ValueError, match='parts_only'):
        lt.logit_topk(x, w[:18], b[:18], k=3, v_off=18, V1=36)
    with pytest.raises(ValueError, match='outside V1'):
        lt.logit_topk(x, w[:18], b[:18], k=3, v_off=20, V1=36,
                      parts_only=True)
    wf, wi = lt.logit_topk(x, w[:18], b[:18], k=3, V1=36, parts_only=True)
    with pytest.raises(ValueError, match=r'wf \[P, N, 5 \+ k\]'):
        lt.logit_topk_merge_parts(wf, wi, V1=36, k=4)


def test_cuda_only_paths_never_take_the_twins():
    """A tensor that is not on the CPU launches the kernel or raises: the
    merge of meta tensors raises and counts no launch."""
    before = lt.logit_topk_merge_parts.launches
    with pytest.raises(ValueError, match='CUDA'):
        lt.logit_topk_merge_parts(
            torch.empty(2, 4, 8, device='meta'),
            torch.empty(2, 4, 3, dtype=torch.int32, device='meta'),
            V1=36, k=3)
    assert lt.logit_topk_merge_parts.launches == before
