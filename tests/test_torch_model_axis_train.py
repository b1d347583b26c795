"""The port's model axis (vocab tensor parallelism) on CPU ranks (gloo)
against the JAX package on its own mesh and against one port process,
float32 (bf16 where named), dropout 0 (the decodes and the RL steps:
``test_torch_model_axis_rl.py``):

* 2 ranks at ``data:1,model:2`` (the vocab V1 = 30 split 15 + 15), each
  holding one shard of ``generator`` and ``tgt_embed`` (the transformer)
  or of ``logit`` (UpDown):
  - (c) two XE steps of the transformer (clip by global norm, so the norm
    sums the shards' squares over the model group) and of UpDown, against
    the JAX ``xe_step`` on ``make_mesh("data:1,model:2")`` with
    ``shard_variables``: the losses within 1e-5 relative (the trajectory
    1e-4), the first step's gathered gradients within 1e-5 of each
    tensor's largest magnitude, the optimizer state after the steps within
    1e-6 (tests/test_torch_train_step.py's bounds); the bf16 XE step
    (float32 masters) against one port process in bf16: losses 1e-3
    relative, gradients 2e-2 of each tensor's largest magnitude plus 5e-4
    of the model's largest (a gradient that is 0 up to rounding, where
    the two shards' partial input gradients round to bf16 apart);
  - (g) the checkpoint: rank 0 writes the gathered model.npz and
    optimizer.npz (equal to one process's arrays), and each rank loads
    them as ``--start_from`` does into its shards and moments (identical
    to the ones it holds);
* 4 ranks at ``data:2,model:2``: the mesh's layout (rank = d * 2 + m, its
  groups) and (e) the transformer's two XE steps of (c) on its 5 images
  (3 + 2 a data index, ragged masks) against the same JAX steps, by (c)'s
  bounds: a denominator summed over the world would halve the loss, one
  summed over the data index alone would weigh the ranks' mask sums
  wrong."""

import numpy as np
import pytest

from captioning_tpu.utils.misc import _flatten_tree
from captioning_tpu_torch.parallel import mesh as pmesh
from tests import torch_model_axis_util as util
from tests.torch_model_axis_util import (NORM_CLIP, TF, check_grads,
                                         check_state, jax_xe, xe_case)
from tests.torch_parallel_util import collect, start_ranks


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the references, the 2 ranks' results, the 4 ranks'): the launches
    run while this process computes the JAX steps and one port process's
    step and checkpoint."""
    root = tmp_path_factory.mktemp('model_axis')
    two = {'xe_transformer': xe_case('transformer', **TF, **NORM_CLIP),
           'xe_updown': xe_case('updown'),
           'xe_transformer_bf16': xe_case('transformer', steps=1,
                                          compute_dtype='bfloat16', **TF)}
    two['xe_transformer']['ckpt'] = str(root / 'ckpt')
    four = {'layout': {'kind': 'layout'},
            'xe_transformer': dict(two['xe_transformer'], ckpt=None)}
    for name in ('two', 'four'):
        (root / name).mkdir()
    started = [start_ranks(root / name, 'model_axis_cases',
                           {'mesh_shape': shape, 'cases': cases}, world,
                           module=util.MODULE)
               for name, shape, cases, world in (
                   ('two', 'data:1,model:2', two, 2),
                   ('four', 'data:2,model:2', four, 4))]
    want = {name: jax_xe(two[name], 'data:1,model:2')
            for name in ('xe_transformer', 'xe_updown')}
    # one port process (no group: the mesh of one rank)
    one = pmesh.current()
    want['xe_transformer_bf16'] = util.xe(two['xe_transformer_bf16'], one)
    want['ckpt'] = util.xe(dict(two['xe_transformer'], ckpt=None), one)
    want['ckpt_dir'] = two['xe_transformer']['ckpt']
    got = [collect(*s, timeout=300) for s in started]
    return want, got[0], got[1]


@pytest.mark.parametrize('model', ['transformer', 'updown'])
def test_xe_steps_equal_the_jax_step_on_its_mesh(runs, model):
    want, ranks, _ = runs
    w = want['xe_' + model]
    r0, r1 = (r['xe_' + model] for r in ranks)
    assert r0['loss'] == r1['loss']
    assert r0['loss'][0] == pytest.approx(w['loss'][0], rel=1e-5)
    np.testing.assert_allclose(r0['loss'], w['loss'], atol=1e-4, rtol=0)
    check_grads(w['grads'], r0['grads'])
    for key in r0['grads']:
        np.testing.assert_array_equal(r0['grads'][key], r1['grads'][key])
    check_state(w['opt_state'], r0['opt_state'])
    # the vocab tensors are sharded 15 + 15, the biases replicated
    vocab = {'transformer': ['generator.weight', 'tgt_embed'],
             'updown': ['logit.weight']}[model]
    assert sorted(r0['shards']) == vocab
    assert all(shape[0] == 15 for shape in r0['shards'].values())
    assert r0['route'].startswith('model axis (model > 1)')


def test_bf16_xe_step_equals_one_process(runs):
    want, ranks, _ = runs
    w, r0 = want['xe_transformer_bf16'], ranks[0]['xe_transformer_bf16']
    assert r0['loss'][0] == pytest.approx(w['loss'][0], rel=1e-3)
    check_grads(w['grads'], r0['grads'], rel=2e-2, floor=5e-4)


def test_checkpoint_is_one_process_and_resumes_into_shards(runs):
    """model.npz holds the full arrays, equal to one process's within 1e-4
    after two adam steps wherever the gradient is not 0 up to rounding
    (adam's rsqrt amplifies the summation-order noise, and moves a tensor
    whose gradient is 0 by the sign of that noise); optimizer.npz within
    1e-6; each rank resumed its shards and moments exactly."""
    from captioning_tpu_torch.utils import misc
    want, ranks, _ = runs
    one, ckpt = want['ckpt'], want['ckpt_dir']
    saved = _flatten_tree(misc.load_pytree(ckpt + '/model.npz'))
    assert sorted(saved) == sorted(one['params'])
    top = max(float(np.abs(g).max()) for g in one['grads'].values())
    moved = 0
    for key, w in one['params'].items():
        assert saved[key].shape == w.shape, key
        if float(np.abs(one['grads'][key]).max()) > 1e-6 * top:
            np.testing.assert_allclose(saved[key], w, atol=1e-4, rtol=0,
                                       err_msg=key)
            moved += 1
    assert moved >= len(one['params']) - 6
    check_state(one['opt_state'], misc.load_flat(ckpt + '/optimizer.npz'))
    assert [r['xe_transformer']['resumed'] for r in ranks] == [0.0, 0.0]


def test_four_ranks_layout_and_xe_step(runs):
    want, _, ranks = runs
    for r, got in enumerate(ranks):
        lay = got['layout']
        assert (lay['data'], lay['model']) == (2, 2)
        assert (lay['data_index'], lay['model_index']) == divmod(r, 2)
        assert lay['model_group'] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert lay['data_group'] == [r % 2, r % 2 + 2]
    w = want['xe_transformer']
    losses = {tuple(got['xe_transformer']['loss']) for got in ranks}
    assert len(losses) == 1
    losses = losses.pop()
    assert losses[0] == pytest.approx(w['loss'][0], rel=1e-5)
    np.testing.assert_allclose(losses, w['loss'], atol=1e-4, rtol=0)
    check_grads(w['grads'], ranks[0]['xe_transformer']['grads'])
    check_state(w['opt_state'], ranks[0]['xe_transformer']['opt_state'])
