"""The port's data-parallel train steps on two CPU ranks (gloo) against the
JAX package's one-device step on the global batch (float32, dropout 0,
ss_prob 0): 5 images x 5 captions, 3 on rank 0 and 2 on rank 1, so the
ranks' mask sums differ (the captions are ragged).

For the XE step of UpDown (kernel B3's twin), of the transformer with
label smoothing, of UpDown with drop-worst and use_bn 1, for the fused
SCST step of both, and for UpDown's RL steps on the other routes (the
SCST step over the host scorer's rewards, the fused structure step with a
margin loss beside XE, the fused PPO step against a frozen old policy,
the unfused structure step over the host scores with drop-worst; the JAX
engine's sampling noise, each rank given its rows of it): the global loss
within 1e-5 relative, each reduced gradient within 1e-5 of its tensor's
largest magnitude (``_check_grads``), the second step's loss (after the
clip and the update of the reduced gradient) within 1e-5 relative, every
other value the step reports (rewards, the XE and structure terms, PPO's
terms) within 1e-5, the ranks' rows of the per-row rewards and sampled
sequences those of the global batch, the BatchNorm running statistics
within 1e-5; both ranks report the same values.  The mean of per-rank
means (DDP's averaging) misses the same bounds: the denominators must be
global.

The JAX trainer's gradients are read by wrapping its ``_apply_updates``
(the jitted step then returns them beside the optimizer state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.utils.misc import _flatten_tree
from tests.torch_parallel_util import collect, start_ranks
from tests.torch_port_util import inputs, jax_draws, tiny_vocab, train_batch
from tests.torch_rl_util import references, rl_opt, write_df
from tests.torch_train_util import model_opt

B, LR = 5, 1e-2
ONE_LAYER = dict(N_enc=1, N_dec=1)
# name -> (step kind, model, options)
CASES = {
    'xe_updown': ('xe', 'updown', {}),
    'label_smoothing': ('xe', 'transformer',
                        dict(ONE_LAYER, label_smoothing=0.1)),
    # the two touch different ends of the step: the features' statistics,
    # the loss's reduction
    'drop_worst_use_bn_1': ('xe', 'updown', {'drop_worst_rate': 0.3,
                                             'use_bn': 1}),
    'sc_fused_updown': ('sc', 'updown', {}),
    'sc_fused_transformer': ('sc', 'transformer', ONE_LAYER),
    'sc_grad_host_scorer': ('sc_grad', 'updown', {}),
    'struc_fused_max_margin': ('struc', 'updown', {
        'structure_loss_type': 'max_margin', 'structure_loss_weight': 0.5}),
    # the old policy from another init
    'struc_fused_ppo': ('struc', 'updown', {'use_ppo': 1}),
    'struc_grad_drop_worst': ('struc_grad', 'updown', {
        'structure_loss_type': 'max_margin', 'structure_loss_weight': 0.5,
        'self_cider_reward_weight': 0.3, 'drop_worst_rate': 0.5}),
}
RL = ('sc', 'sc_grad', 'struc', 'struc_grad')
RL_CASES = [name for name, (kind, _, _) in CASES.items() if kind in RL]


def _case(kind, model, kw, df_path):
    """The ranks' payload: options, the port's seeded init as JAX
    variables (PPO's old policy's too) and the global batch (with the
    references and the sampling noise for the RL steps)."""
    from captioning_tpu_torch.models.api import setup
    opt = (rl_opt if kind in RL else model_opt)(model, **kw)

    def init(seed):
        cap = setup(opt, tiny_vocab(), device='cpu')
        cap.init_params(torch.Generator().manual_seed(seed))
        return cap
    pcap = init(0)
    fc, att, am = inputs(B)
    case = dict(kind=kind, opt=opt, variables=pcap.jax_variables(), fc=fc,
                att=att, am=am, lr=LR, df_path=df_path,
                drop_worst='drop_worst_rate' in kw, local=kind == 'xe' and
                model == 'updown' and not kw)
    if kw.get('use_ppo'):
        case['old_variables'] = init(1).jax_variables()
    if kind in ('xe', 'struc', 'struc_grad'):
        case['labels'], case['masks'] = train_batch(
            B, 5 if kind == 'xe' else int(opt.train_sample_n))
    if kind in RL:
        case['gts'], case['refs'], case['ref_mask'] = references(
            pcap, fc, att, am)
        draw = jax_draws(7, pcap.cfg.seq_length)
        rows = B * int(opt.train_sample_n)
        case['noise'] = [draw('gumbel', t, (rows, pcap.cfg.vocab_size + 1))
                         .numpy() for t in range(pcap.cfg.seq_length)]
    return case


def _jax_side(case):
    """The JAX one-device step(s) on the global batch: losses, the first
    step's gradients (flat 'params/...'), the BatchNorm statistics after,
    the other reported values and the per-row rewards and samples."""
    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.modules.trainer import Trainer as JaxTrainer
    from captioning_tpu.ops.cider_device import DeviceCiderD as JaxCiderD
    from captioning_tpu_torch.utils import rewards
    opt = case['opt']
    old = case.get('old_variables')
    jt = JaxTrainer(jax_setup(opt, tiny_vocab()), opt,
                    old_variables=None if old is None else
                    jax.tree.map(jnp.asarray, old))
    apply = jt._apply_updates

    def keep_grads(variables, state, grads, lr):
        variables, state = apply(variables, state[0], grads, lr)
        return variables, (state, grads)
    jt._apply_updates = keep_grads
    variables = jax.tree.map(jnp.asarray, case['variables'])
    state = (jt.init_opt_state(variables),
             jax.tree.map(jnp.zeros_like, variables['params']))
    j = {k: jnp.asarray(v) for k, v in case.items()
         if k in ('fc', 'att', 'am', 'ref_mask', 'masks')}
    j.update({k: jnp.asarray(case[k], jnp.int32) for k in ('labels', 'refs')
              if k in case})
    out = {'loss': [], 'rows': {}}
    if case['kind'] == 'xe':
        for s in range(2):
            variables, state, o = jt.xe_step(
                variables, state, j['fc'], j['att'], j['labels'],
                j['masks'], j['am'], LR, 0.0,
                jax.random.PRNGKey(s), drop_worst_flag=case['drop_worst'])
            out['loss'].append(float(o['loss']))
            if s == 0:
                out['grads'] = _flatten_tree({'params': jax.tree.map(
                    np.asarray, state[1])})
        out['batch_stats'] = _flatten_tree({'batch_stats': jax.tree.map(
            np.asarray, variables.get('batch_stats', {}))}) \
            if 'batch_stats' in variables else {}
        return out
    rng = jax.random.PRNGKey(7)
    feats = (j['fc'], j['att'])
    if case['kind'] == 'sc':
        variables, state, o = jt.sc_fused_step(
            variables, state, *feats, j['am'], j['refs'], j['ref_mask'], LR,
            rng, rng, JaxCiderD(case['df_path']))
    elif case['kind'] == 'struc':
        variables, state, o = jt.struc_fused_step(
            variables, state, *feats, j['labels'], j['masks'], j['am'],
            j['refs'], j['ref_mask'], LR, rng, rng,
            JaxCiderD(case['df_path']))
    else:
        # the port's scorers are process-wide and made once: start them
        # from this case's df, whatever an earlier test of this process
        # loaded (the ranks are fresh processes)
        rewards.CiderD_scorer = rewards.Cider_scorer = None
        rewards.Bleu_scorer = None
        rewards.init_scorer(case['df_path'])
        gts = case['gts']
        if case['kind'] == 'sc_grad':
            greedy, seq = (np.asarray(s) for s in jt.sc_decode(
                variables, *feats, j['am'], rng, rng))
            reward = rewards.get_self_critical_reward(greedy, gts, seq, opt)
            variables, state, o = jt.sc_grad_step(
                variables, state, *feats, j['am'], jnp.asarray(seq),
                jnp.asarray(reward), LR, rng)
            o = dict(o, reward=reward[:, 0].mean())
            out['rows']['greedy'] = greedy
        else:
            seq = np.asarray(jt.struc_decode(variables, *feats, j['am'],
                                             rng))
            variables, state, o = jt.struc_grad_step(
                variables, state, *feats, j['labels'], j['masks'], j['am'],
                jnp.asarray(seq), rewards.get_scores(gts, seq, opt),
                rewards.get_self_cider_scores(gts, seq, opt), LR, rng, rng,
                drop_worst_flag=case['drop_worst'])
        out['rows']['sampled'] = seq
    out['loss'].append(float(o.pop('loss')))
    o = {k: np.asarray(v) for k, v in o.items()}
    out['scalars'] = {k: float(v) for k, v in o.items() if v.ndim == 0}
    out['rows'].update({k: v for k, v in o.items() if v.ndim})
    out['grads'] = _flatten_tree({'params': jax.tree.map(np.asarray,
                                                         state[1])})
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{case: (the JAX side, [rank 0's result, rank 1's])}: the ranks run
    every case in one launch while this process runs the JAX side."""
    root = tmp_path_factory.mktemp('parallel_train')
    df_path = write_df(root)[0]
    cases = {name: _case(kind, model, kw, df_path)
             for name, (kind, model, kw) in CASES.items()}
    procs, outs = start_ranks(root, 'train_cases', cases)
    want = {name: _jax_side(case) for name, case in cases.items()}
    got = collect(procs, outs, timeout=300)
    return {name: (want[name], [r[name] for r in got]) for name in cases}


def _check_grads(want, got, rel=1e-5):
    """Each gradient within ``rel`` of its tensor's largest magnitude, plus
    1e-7 of the model's largest: the rounding of a gradient that is
    exactly 0 (a bias added to every score of a softmax row)."""
    assert sorted(got) == sorted(want) and want
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        np.testing.assert_allclose(
            got[key], w, rtol=0, err_msg=key,
            atol=rel * float(np.abs(w).max()) + 1e-7 * top)


@pytest.mark.parametrize('case', CASES)
def test_two_ranks_step_as_one_device_on_the_global_batch(runs, case):
    want, (r0, r1) = runs[case]
    assert r0['loss'] == r1['loss']                  # global, on each rank
    for w, g in zip(want['loss'], r0['loss']):
        assert g == pytest.approx(w, rel=1e-5)
    _check_grads(want['grads'], r0['grads'])
    for key in r0['grads']:
        np.testing.assert_array_equal(r0['grads'][key], r1['grads'][key])
    assert r0['route'].startswith('data-parallel (world > 1)')
    assert r0.get('scalars') == r1.get('scalars')
    for key, w in want.get('scalars', {}).items():
        assert r0['scalars'][key] == pytest.approx(w, rel=1e-5, abs=1e-5), \
            key
    for key, w in want.get('rows', {}).items():
        g = np.concatenate([r0['rows'][key], r1['rows'][key]])
        if g.dtype.kind == 'f':
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    if case in RL_CASES:
        assert want['scalars'] and r0['rows']
        # each rank sampled and scored its own images' rows: 3 and 2 images
        for key in r0['rows']:
            assert len(r0['rows'][key]) * 2 == len(r1['rows'][key]) * 3, key
    for key, w in want.get('batch_stats', {}).items():
        assert not np.allclose(w, w.flat[0])         # the stats moved
        np.testing.assert_allclose(r0['batch_stats'][key], w, atol=1e-5,
                                   rtol=0, err_msg=key)
        np.testing.assert_array_equal(r0['batch_stats'][key],
                                      r1['batch_stats'][key])
    assert bool(want.get('batch_stats')) == (case == 'drop_worst_use_bn_1')


def test_mean_of_rank_means_misses_the_bound(runs):
    """What DDP's averaging gives (each rank's own mean, then the mean
    over ranks) is off the global loss and gradient by more than the
    bounds above: the ragged masks' sums differ between the ranks."""
    want, ranks = runs['xe_updown']
    (l0, g0), (l1, g1) = (r['local'] for r in ranks)
    assert abs((l0 + l1) / 2 - want['loss'][0]) > 1e-5 * abs(
        want['loss'][0])
    with pytest.raises(AssertionError):
        _check_grads(want['grads'], {k: (g0[k] + g1[k]) / 2 for k in g0})
