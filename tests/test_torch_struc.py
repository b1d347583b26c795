"""The port's structure-loss and PPO steps (``Trainer.struc_decode`` /
``struc_grad_step`` / ``struc_fused_step``) against the JAX package's, on
the CPU in float32 at tiny widths, the JAX engine's sampling noise handed
to the port:

* the fused step (new_self_critical with the XE term at weight 0.5 and the
  self-CIDEr reward) of UpDown and the transformer: the loss within 1e-5
  relative, a 3-step trajectory within 1e-4, the scores within 1e-5;
* the unfused step over the host scores for a margin loss on logits, seqnll
  at weight 1 and pure XE at weight 0;
* PPO against a frozen old policy, fused and unfused;
* drop-worst;
* under dropout 0.5 the fused step equals struc_decode + struc_grad_step
  within 1e-6;
* the BatchNorm running statistics after a step with the XE term equal
  the JAX ones (use_bn 1 and 2)."""

import numpy as np
import pytest
import torch

from tests.torch_rl_util import (B, N_SAMPLE, Both, check_bn,
                                 check_trajectory, write_df)


@pytest.fixture(scope='module')
def df_path(tmp_path_factory):
    return write_df(tmp_path_factory.mktemp('struc'))[0]


def _fused(both, steps=3, seed=0):
    """``steps`` fused structure steps on both sides: (JAX outputs, port
    outputs, JAX variables after)."""
    jt, pt = both.jt, both.pt
    data = ('fc', 'att', 'labels', 'masks', 'am', 'refs', 'ref_mask')
    jin, pin = both.jargs(*data), both.pargs(*data)
    variables, state = both.variables, both.state
    want, got = [], []
    for step in range(seed, seed + steps):
        jrng, pdraw = both.draws(step)
        variables, state, out = jt.struc_fused_step(
            variables, state, *jin, 1e-2, jrng, jrng, both.jsc)
        want.append(out)
        got.append(pt.struc_fused_step(
            *pin, 1e-2, pdraw, torch.Generator().manual_seed(step),
            torch.Generator().manual_seed(100 + step), both.psc))
    return want, got, variables


def _unfused(both, steps=1, drop_worst=False):
    """``steps`` struc_decode + host scores + struc_grad_step on both
    sides, the sequences required identical: (JAX outputs, port
    outputs)."""
    from captioning_tpu_torch.utils import rewards
    jt, pt = both.jt, both.pt
    data = ('fc', 'att', 'labels', 'masks', 'am')
    jin, pin = both.jargs(*data), both.pargs(*data)
    jdec, pdec = both.jargs('fc', 'att', 'am'), both.pargs('fc', 'att', 'am')
    variables, state = both.variables, both.state
    want, got = [], []
    for step in range(steps):
        jrng, pdraw = both.draws(step)
        gen = torch.Generator().manual_seed(step)
        js = jt.struc_decode(variables, *jdec, jrng)
        ps = pt.struc_decode(*pdec, pdraw, gen)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        scores = rewards.get_scores(both.gts, ps.numpy(), both.opt)
        sc = rewards.get_self_cider_scores(both.gts, ps.numpy(), both.opt)
        variables, state, out = jt.struc_grad_step(
            variables, state, *jin, js, scores, sc, 1e-2, jrng, jrng,
            drop_worst_flag=drop_worst)
        want.append(out)
        got.append(pt.struc_grad_step(
            *pin, ps, torch.from_numpy(scores), torch.from_numpy(sc), 1e-2,
            gen, torch.Generator().manual_seed(100 + step),
            drop_worst_flag=drop_worst))
    return want, got


def _same_outputs(want, got, keys):
    for w, g in zip(want, got):
        for k in keys:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_struc_fused_step_matches_jax(df_path, model):
    both = Both(model, df_path, structure_loss_weight=0.5,
                self_cider_reward_weight=0.5)
    want, got, _ = _fused(both)
    check_trajectory([float(o['loss']) for o in want],
                     [float(o['loss']) for o in got])
    _same_outputs(want, got, ('reward', 'lm_loss', 'struc_loss'))
    assert float(np.asarray(want[0]['reward']).std()) > 0


@pytest.mark.parametrize('loss_type,weight', [
    ('max_margin', 0.5), ('seqnll', 1.0), ('new_self_critical', 0.0)])
def test_struc_decode_and_grad_step_match_jax(df_path, loss_type, weight):
    """UpDown: a margin loss over logits (the sampling pass outputs logits
    too) mixed with XE, seqnll alone, and weight 0 (XE through the
    structure path, its reward the scores)."""
    both = Both('updown', df_path, structure_loss_type=loss_type,
                structure_loss_weight=weight, self_cider_reward_weight=0.3)
    assert both.pt.struc_out_ls == ('margin' not in loss_type)
    want, got = _unfused(both, steps=2)
    check_trajectory([float(o['loss']) for o in want],
                     [float(o['loss']) for o in got])
    _same_outputs(want, got, ('reward', 'lm_loss', 'struc_loss'))


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
def test_ppo_matches_jax(df_path, fused):
    """PPO (clip 0.2, KL 0.02) against a frozen old policy from another
    init: the loss, its pg / KL terms and the clip fraction; the old policy
    keeps its weights."""
    both = Both('updown', df_path, use_ppo=1, old_seed=1)
    old = {k: v.clone() for k, v in
           both.pt.old_captioner.module.state_dict().items()}
    want, got = (_fused(both, steps=2)[:2] if fused
                 else _unfused(both, steps=2))
    check_trajectory([float(o['loss']) for o in want],
                     [float(o['loss']) for o in got])
    _same_outputs(want, got, ('reward', 'pg_loss', 'kl_loss', 'clipfrac'))
    for k, v in both.pt.old_captioner.module.state_dict().items():
        assert torch.equal(v, old[k]), k
    assert not any(p.requires_grad for p in
                   both.pt.old_captioner.module.parameters())


def test_struc_drop_worst_matches_jax(df_path):
    both = Both('updown', df_path, structure_loss_weight=0.5,
                self_cider_reward_weight=0.3,
                structure_loss_type='max_margin')
    want, got = _unfused(both, drop_worst=True)
    assert float(got[0]['loss']) == pytest.approx(float(want[0]['loss']),
                                                  rel=1e-5)
    assert got[0]['reward'].shape == (B, N_SAMPLE)


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_struc_fused_equals_unfused_under_dropout(df_path, model):
    """Under dropout 0.5, with the XE term (its own dropout generator) at
    weight 0.5: one loss and one update within 1e-6."""
    runs = []
    for fused in (True, False):
        both = Both(model, df_path, structure_loss_weight=0.5,
                    drop_prob_lm=0.5, dropout=0.5)
        pt = both.pt
        data = ('fc', 'att', 'labels', 'masks', 'am')
        _, pdraw = both.draws(3)
        gen, gen_lm = (torch.Generator().manual_seed(k) for k in (5, 6))
        if fused:
            out = pt.struc_fused_step(*both.pargs(*data, 'refs', 'ref_mask'),
                                      1e-2, pdraw, gen, gen_lm, both.psc)
        else:
            ps = pt.struc_decode(*both.pargs('fc', 'att', 'am'), pdraw, gen)
            scores = both.psc.score_grouped(
                ps, *both.pargs('refs', 'ref_mask'), N_SAMPLE)
            out = pt.struc_grad_step(*both.pargs(*data), ps, scores, None,
                                     1e-2, gen, gen_lm)
        runs.append((float(out['loss']), {
            k: v.detach().clone()
            for k, v in both.pcap.module.state_dict().items()}))
    (lf, sf), (lu, su) = runs
    assert lu == pytest.approx(lf, abs=1e-6)
    for k in sf:
        np.testing.assert_allclose(su[k].numpy(), sf[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize('use_bn', [1, 2])
def test_struc_bn_statistics_match_jax(df_path, use_bn):
    """The structure step with its XE term: the running statistics move
    once, from the sampling pass's prepare (the XE term's new statistics
    are dropped, as in JAX)."""
    both = Both('updown', df_path, use_bn=use_bn, structure_loss_weight=0.5)
    _, _, variables = _fused(both, steps=1)
    check_bn(variables, both.pcap)
