"""The port's model axis on 2 CPU ranks (gloo) at ``data:1,model:2``
(the vocab V1 = 30 split 15 + 15), float32, dropout 0:

* (d) beam 5 and greedy of the transformer (B2 in shard mode by its twins:
  each rank's parts all-gathered and merged) and of UpDown (the engine's
  plain route over the gathered logits), token-identical to the JAX
  ``sample_beam_jit`` / ``sample_stats_jit`` on ``make_mesh("data:1,
  model:2")`` with ``shard_variables``, on both ranks;
* (f) the fused SCST step of the transformer (its greedy baseline through
  B2's shard mode) and the fused structure step (new_self_critical beside
  XE at weight 0.5) and PPO step of UpDown, against one port process on
  the JAX engine's sampling noise: the sequences identical, the reported
  values within 1e-5, the gathered gradients within 1e-5 of each tensor's
  largest magnitude, on both ranks."""

import numpy as np
import pytest

from captioning_tpu_torch.parallel import mesh as pmesh
from tests import torch_model_axis_util as util
from tests.torch_model_axis_util import TF, check_grads, jax_decode, \
    rl_case, xe_case
from tests.torch_parallel_util import collect, start_ranks
from tests.torch_rl_util import write_df


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(the references, the 2 ranks' results): the launch runs while this
    process computes the JAX decodes and one port process's steps."""
    root = tmp_path_factory.mktemp('model_axis_rl')
    df_path = write_df(root)[0]
    cases = {'decode_transformer': dict(xe_case('transformer', **TF),
                                        kind='decode', beam=5),
             'decode_updown': dict(xe_case('updown'), kind='decode',
                                   beam=5),
             'sc_transformer': rl_case('sc', 'transformer', df_path, **TF),
             'struc_updown': rl_case('struc', 'updown', df_path,
                                     structure_loss_weight=0.5),
             'ppo_updown': rl_case('struc', 'updown', df_path, use_ppo=1)}
    started = start_ranks(root, 'model_axis_cases',
                          {'mesh_shape': 'data:1,model:2', 'cases': cases},
                          2, module=util.MODULE)
    want = {name: jax_decode(cases[name], 'data:1,model:2')
            for name in ('decode_transformer', 'decode_updown')}
    one = pmesh.current()
    for name in ('sc_transformer', 'struc_updown', 'ppo_updown'):
        want[name] = util.rl(cases[name], one)
    return want, collect(*started, timeout=300)


@pytest.mark.parametrize('model', ['transformer', 'updown'])
def test_beam_and_greedy_tokens_equal_the_jax_mesh(runs, model):
    want, ranks = runs
    w = want['decode_' + model]
    for r in ranks:
        got = r['decode_' + model]
        np.testing.assert_array_equal(got['beam'], w['beam'])
        np.testing.assert_array_equal(got['greedy'], w['greedy'])
        assert got['route'].startswith('model axis')


@pytest.mark.parametrize('case', ['sc_transformer', 'struc_updown',
                                  'ppo_updown'])
def test_fused_rl_steps_equal_one_process(runs, case):
    want, ranks = runs
    w = want[case]
    for r in ranks:
        got = r[case]
        assert sorted(got['values']) == sorted(w['values'])
        for key, v in w['values'].items():
            if v.dtype.kind == 'f':
                np.testing.assert_allclose(got['values'][key], v, atol=1e-5,
                                           rtol=1e-5, err_msg=key)
            else:
                np.testing.assert_array_equal(got['values'][key], v,
                                              err_msg=key)
        check_grads(w['grads'], got['grads'])
        assert got['route'].startswith('model axis')


