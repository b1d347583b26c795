"""The port's SCST steps (``Trainer.sc_decode`` / ``sc_grad_step`` /
``sc_fused_step``) against the JAX package's, on the CPU in float32, for
UpDown and the transformer at tiny widths, the JAX engine's sampling noise
handed to the port:

* at dropout 0 the greedy and sampled sequences of each decode are
  identical, the rewards within 1e-5, the loss within 1e-5 relative and a
  3-step trajectory within 1e-4 (the fused step on the card's CIDEr-D; the
  unfused one on the host scorer), the optimizer state within 1e-6;
* under dropout 0.5 the fused step equals sc_decode + sc_grad_step within
  1e-6 (the recompute draws the decode's dropout again);
* the BatchNorm running statistics after a step equal the JAX ones
  (use_bn 1 and 2), fused and unfused;
* drop-worst through sc_grad_step."""

import numpy as np
import pytest
import torch

from tests.torch_rl_util import (B, N_SAMPLE, Both, check_bn,
                                 check_trajectory, write_df)
from tests.torch_train_util import check_opt_state

MODELS = ['updown', 'transformer']


@pytest.fixture(scope='module')
def df_path(tmp_path_factory):
    return write_df(tmp_path_factory.mktemp('scst'))[0]


@pytest.mark.parametrize('model', MODELS)
def test_sc_fused_step_matches_jax(df_path, model):
    both = Both(model, df_path)
    jt, pt = both.jt, both.pt
    jin = both.jargs('fc', 'att', 'am')
    pin = both.pargs('fc', 'att', 'am')
    refs_j, refs_p = both.jargs('refs', 'ref_mask'), both.pargs('refs',
                                                               'ref_mask')
    want, got, want_r, got_r = [], [], [], []
    variables, state = both.variables, both.state
    for step in range(3):
        jrng, pdraw = both.draws(step)
        variables, state, out = jt.sc_fused_step(
            variables, state, *jin, *refs_j, 1e-2, jrng, jrng, both.jsc)
        pout = pt.sc_fused_step(*pin, *refs_p, 1e-2, None, pdraw,
                                torch.Generator().manual_seed(step),
                                both.psc)
        want.append(float(out['loss']))
        got.append(float(pout['loss']))
        want_r.append(float(out['reward']))
        got_r.append(float(pout['reward']))
    check_trajectory(want, got)
    np.testing.assert_allclose(got_r, want_r, atol=1e-5, rtol=0)
    assert len(set(np.round(want, 4))) == 3        # the steps moved it
    check_opt_state(state, pt)


@pytest.mark.parametrize('model', MODELS)
def test_sc_decode_and_grad_step_match_jax(df_path, model):
    """The unfused SCST iteration, rewards from the host scorer
    (``utils/rewards.get_self_critical_reward`` of each package)."""
    from captioning_tpu.utils import rewards as jrewards
    from captioning_tpu_torch.utils import rewards
    both = Both(model, df_path)
    jrewards.CiderD_scorer = rewards.CiderD_scorer
    jt, pt = both.jt, both.pt
    jin = both.jargs('fc', 'att', 'am')
    pin = both.pargs('fc', 'att', 'am')
    variables, state = both.variables, both.state
    want, got = [], []
    for step in range(3):
        jrng, pdraw = both.draws(step)
        jg, js = jt.sc_decode(variables, *jin, jrng, jrng)
        gen = torch.Generator().manual_seed(step)
        pg, ps = pt.sc_decode(*pin, None, pdraw, gen)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
        jreward = jrewards.get_self_critical_reward(
            np.asarray(jg), both.gts, np.asarray(js), both.opt)
        preward = rewards.get_self_critical_reward(
            pg.numpy(), both.gts, ps.numpy(), both.opt)
        np.testing.assert_allclose(preward, jreward, atol=1e-5, rtol=0)
        variables, state, out = jt.sc_grad_step(
            variables, state, *jin, js, jreward, 1e-2, jrng)
        want.append(float(out['loss']))
        got.append(float(pt.sc_grad_step(*pin, ps, torch.from_numpy(preward),
                                         1e-2, gen)['loss']))
    jrewards.CiderD_scorer = None
    check_trajectory(want, got)


def _port_step(model, df_path, fused, use_bn=0, drop=0.5):
    """One port SCST step, fused or sc_decode + sc_grad_step with the
    card's reward, at ``drop``: (loss, parameters and buffers after)."""
    kw = dict(drop_prob_lm=drop, dropout=drop, use_bn=use_bn)
    both = Both(model, df_path, **kw)
    pt = both.pt
    pin = both.pargs('fc', 'att', 'am')
    refs = both.pargs('refs', 'ref_mask')
    _, pdraw = both.draws(5)
    gen = torch.Generator().manual_seed(9)
    if fused:
        out = pt.sc_fused_step(*pin, *refs, 1e-2, None, pdraw, gen, both.psc)
    else:
        pg, ps = pt.sc_decode(*pin, None, pdraw, gen)
        reward = both.psc.self_critical_reward(pg, ps, *refs)
        out = pt.sc_grad_step(*pin, ps, reward, 1e-2, gen)
    state = {k: v.detach().clone()
             for k, v in both.pcap.module.state_dict().items()}
    return float(out['loss']), state


@pytest.mark.parametrize('model', MODELS)
def test_fused_equals_unfused_under_dropout(df_path, model):
    """Under dropout 0.5 the fused step and sc_decode + sc_grad_step (its
    recompute drawing the decode's masks again) give one loss and one
    update, within 1e-6."""
    lf, sf = _port_step(model, df_path, fused=True)
    lu, su = _port_step(model, df_path, fused=False)
    assert lu == pytest.approx(lf, abs=1e-6)
    for k in sf:
        np.testing.assert_allclose(su[k].numpy(), sf[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize('use_bn', [1, 2])
@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
def test_bn_statistics_match_jax(df_path, use_bn, fused):
    """One SCST step of UpDown with the masked BatchNorm: the running
    statistics move once, from the sampling pass's prepare, as the JAX
    step threads them (the eval baseline reads them; the unfused grad
    step's recompute leaves them)."""
    both = Both('updown', df_path, use_bn=use_bn)
    jt, pt = both.jt, both.pt
    jin, pin = both.jargs('fc', 'att', 'am'), both.pargs('fc', 'att', 'am')
    refs_j, refs_p = both.jargs('refs', 'ref_mask'), both.pargs('refs',
                                                               'ref_mask')
    jrng, pdraw = both.draws(4)
    gen = torch.Generator().manual_seed(4)
    if fused:
        variables, _, _ = jt.sc_fused_step(
            both.variables, both.state, *jin, *refs_j, 1e-2, jrng, jrng,
            both.jsc)
        pt.sc_fused_step(*pin, *refs_p, 1e-2, None, pdraw, gen, both.psc)
    else:
        jg, js = jt.sc_decode(both.variables, *jin, jrng, jrng)
        pg, ps = pt.sc_decode(*pin, None, pdraw, gen)
        reward = both.psc.self_critical_reward(pg, ps, *refs_p)
        variables, _, _ = jt.sc_grad_step(both.variables, both.state, *jin,
                                          js, reward.numpy(), 1e-2, jrng)
        pt.sc_grad_step(*pin, ps, reward, 1e-2, gen)
    check_bn(variables, both.pcap)


def test_drop_worst_matches_jax(df_path):
    """sc_grad_step with drop-worst: the mean of the per-sequence losses
    less the worst half."""
    both = Both('updown', df_path)
    jt, pt = both.jt, both.pt
    jin, pin = both.jargs('fc', 'att', 'am'), both.pargs('fc', 'att', 'am')
    jrng, pdraw = both.draws(6)
    _, js = jt.sc_decode(both.variables, *jin, jrng, jrng)
    gen = torch.Generator().manual_seed(6)
    pg, ps = pt.sc_decode(*pin, None, pdraw, gen)
    reward = both.psc.self_critical_reward(pg, ps,
                                           *both.pargs('refs', 'ref_mask'))
    out = jt.sc_grad_step(both.variables, both.state, *jin, js,
                          reward.numpy(), 1e-2, jrng,
                          drop_worst_flag=True)[2]
    got = pt.sc_grad_step(*pin, ps, reward, 1e-2, gen, drop_worst_flag=True)
    assert float(got['loss']) == pytest.approx(float(out['loss']), rel=1e-5)
    assert B * N_SAMPLE == ps.shape[0]
