"""Train-mode sampling by beam search and by diverse groups on the port
against the JAX package, on the CPU in float32 at dropout 0 (the two
packages' dropout streams never agree; ``tests/test_torch_train_random.py``
holds the sites), for the transformer (B1 and B2 by their twins), UpDown
(B3 and B6 by their twins) and AdaAtt (one feats row a beam lane).

* ``train_beam_size`` 3, ``train_sample_n`` 3 through the ``Trainer``s of
  both packages: the unfused SCST and structure decodes give the same
  sequences token for token; the fused SCST step (the replayed winners'
  tables) and the unfused structure step (``scan_logprobs`` over the
  beams) give losses within 1e-5 relative and gradients within 1e-5 of
  each tensor's max, for each model; UpDown's unfused SCST step and fused
  structure step too.  The gradients are read from Adam's first moment
  after one step from a zero state (0.1 x the gradient; the clip is out of
  reach).  The structure loss is ``best_of_n`` (see ``BEAM``).
* ``group_size`` 2 at ``diversity_lambda`` 0.5 (diverse beam 4 with
  ``sample_n`` 2 for each model, and diverse greedy sampling for the
  transformer and UpDown): neither package's
  ``Trainer`` passes ``group_size`` to its sampling pass, so the decodes
  are driven through ``Captioner.sample_train`` and the JAX
  ``decoding.sample`` on a train-bound model, with the SCST loss (and for
  the beam the structure loss) over the fused tables and over the
  recompute, each gradient by ``jax.grad`` and by autograd.
* The graph route of a fused step that samples by beam gives its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_rl_util import N_SAMPLE, Both, write_df

MODELS = ['transformer', 'updown', 'adaatt']
# best_of_n: new_self_critical over a tiny model's beams, whose winners
# have near-equal logprobs, is a difference of near-equal terms that float32
# resolves to ~1e-7 of its own size in either package
BEAM = dict(train_beam_size=3, train_sample_method='greedy',
            grad_clip_value=1e4, N_enc=1, N_dec=1,
            structure_loss_type='best_of_n')
MU = '#1/#0/#1/'          # Adam's first moment in the optax layout


@pytest.fixture(scope='module')
def df_path(tmp_path_factory):
    return write_df(tmp_path_factory.mktemp('train_beam'))[0]


def check_grads(want, got):
    """Each tensor within 1e-5 of the JAX tensor's max magnitude, plus 1e-7
    of the model's largest: the rounding of a gradient that is exactly 0
    (a bias added to every score of a softmax row), as
    ``tests/test_torch_parallel_train.py`` holds it."""
    assert sorted(got) == sorted(want) and want
    top = max(float(np.abs(w).max()) for w in want.values())
    assert top > 0
    for key, w in want.items():
        np.testing.assert_allclose(
            got[key], w, rtol=0, err_msg=key,
            atol=1e-5 * float(np.abs(w).max()) + 1e-7 * top)


def moment_grads(state, pt):
    """(JAX, port) gradients of one Adam step from a zero state."""
    from captioning_tpu.utils.misc import _flatten_tree
    want = _flatten_tree(jax.tree.map(np.asarray, state))
    got = pt.opt_state_jax()
    return ({k: want[k] / 0.1 for k in want if k.startswith(MU)},
            {k: got[k] / 0.1 for k in got if k.startswith(MU)})


@pytest.mark.parametrize('model', MODELS)
def test_trainer_beam_steps_match_jax(df_path, model):
    """The unfused decodes' sequences, the fused SCST step (the replayed
    winners' tables carry the gradient) and the unfused structure step
    (``scan_logprobs`` over the beams, host scores)."""
    both = Both(model, df_path, **BEAM)
    jt, pt = both.jt, both.pt
    jin, pin = both.jargs('fc', 'att', 'am'), both.pargs('fc', 'att', 'am')
    refs_j = both.jargs('refs', 'ref_mask')
    refs_p = both.pargs('refs', 'ref_mask')
    jrng, pdraw = both.draws(0)
    gen = torch.Generator().manual_seed(0)

    # the unfused decodes: the beams' winners, 3 a row
    jg, js = jt.sc_decode(both.variables, *jin, jrng, jrng)
    pg, ps = pt.sc_decode(*pin, None, pdraw, gen)
    assert ps.shape == (3 * N_SAMPLE, both.L)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    ps_struc = pt.struc_decode(*pin, pdraw, gen)
    np.testing.assert_array_equal(ps_struc.numpy(), np.asarray(js))

    _, state, out = jt.sc_fused_step(both.variables, both.state, *jin,
                                     *refs_j, 1e-2, jrng, jrng, both.jsc)
    pout = pt.sc_fused_step(*pin, *refs_p, 1e-2, None, pdraw, gen, both.psc)
    np.testing.assert_array_equal(pout['sampled'].numpy(), np.asarray(js))
    assert float(pout['loss']) == pytest.approx(float(out['loss']),
                                                rel=1e-5)
    assert float(pout['reward']) == pytest.approx(float(out['reward']),
                                                  abs=1e-5)
    check_grads(*moment_grads(state, pt))

    both = Both(model, df_path, **BEAM)
    _struc_grad_step(both, js, jrng)


def _struc_grad_step(both, js, jrng):
    """One struc_grad_step over the beams ``js`` with random host scores
    on both sides, from the initial weights."""
    jt, pt = both.jt, both.pt
    gen = torch.Generator().manual_seed(1)
    data_j = both.jargs('fc', 'att', 'labels', 'masks', 'am')
    data_p = both.pargs('fc', 'att', 'labels', 'masks', 'am')
    scores = np.random.RandomState(1).rand(3 * N_SAMPLE).astype('float32')
    _, state, out = jt.struc_grad_step(
        both.variables, both.state, *data_j, js, jnp.asarray(scores), None,
        1e-2, jrng, jrng)
    pout = pt.struc_grad_step(*data_p, torch.from_numpy(np.asarray(js)),
                              torch.from_numpy(scores), None, 1e-2, gen, gen)
    assert float(pout['loss']) == pytest.approx(float(out['loss']),
                                                rel=1e-5)
    check_grads(*moment_grads(state, pt))


def test_updown_beam_sc_grad_and_struc_fused_match_jax(df_path):
    """UpDown's other two routes: sc_grad_step over the beams (the
    recompute) and the fused structure step (the replayed tables, scored
    on the card's CIDEr-D)."""
    both = Both('updown', df_path, **BEAM)
    jt, pt = both.jt, both.pt
    jin, pin = both.jargs('fc', 'att', 'am'), both.pargs('fc', 'att', 'am')
    jrng, _ = both.draws(1)
    gen = torch.Generator().manual_seed(1)
    _, js = jt.sc_decode(both.variables, *jin, jrng, jrng)
    reward = np.random.RandomState(0).randn(*np.asarray(js).shape).astype(
        'float32')
    _, state, out = jt.sc_grad_step(both.variables, both.state, *jin, js,
                                    jnp.asarray(reward), 1e-2, jrng)
    pout = pt.sc_grad_step(*pin, torch.from_numpy(np.asarray(js)),
                           torch.from_numpy(reward), 1e-2, gen)
    assert float(pout['loss']) == pytest.approx(float(out['loss']),
                                                rel=1e-5)
    check_grads(*moment_grads(state, pt))

    both = Both('updown', df_path, **BEAM)
    jt, pt = both.jt, both.pt
    _, state, out = jt.struc_fused_step(
        both.variables, both.state,
        *both.jargs('fc', 'att', 'labels', 'masks', 'am', 'refs',
                    'ref_mask'), 1e-2, jrng, jrng, both.jsc)
    pout = pt.struc_fused_step(
        *both.pargs('fc', 'att', 'labels', 'masks', 'am', 'refs',
                    'ref_mask'), 1e-2, None, gen, gen, both.psc)
    assert float(pout['loss']) == pytest.approx(float(out['loss']),
                                                rel=1e-5)
    check_grads(*moment_grads(state, pt))


DIVERSE = {'beam4g2': dict(sample_method='greedy', beam_size=4,
                           group_size=2, diversity_lambda=0.5, sample_n=2),
           'greedy_g2': dict(sample_method='greedy', beam_size=1,
                             group_size=2, diversity_lambda=0.5)}


def _losses(lib, lp, lp_re, seq, reward, scores, G):
    """The SCST loss over the fused tables (a diverse sampling pass gives
    the chosen tokens' logprobs [N, L]: the same masked sum over them), the
    same over the recompute, and for a beam the structure loss over each."""
    mask = lib.reward_mask(seq)
    if lp.ndim == 2:
        fused = -(lp * reward * mask).sum() / mask.sum()
    else:
        fused = lib.losses.reward_criterion(lp, seq, reward)
    out = [fused, lib.losses.reward_criterion(lp_re, seq, reward)]
    if lp.ndim == 3:
        for x in (lp, lp_re):
            out.append(lib.losses.structure_loss(
                x, seq, scores, 'best_of_n', G)['loss'])
    return out


class _Jax:
    from captioning_tpu.modules import losses

    @staticmethod
    def reward_mask(seq):
        return _Jax.losses._reward_mask(seq)


class _Port:
    from captioning_tpu_torch.modules import losses

    @staticmethod
    def reward_mask(seq):
        return _Port.losses._reward_mask(seq)


# diverse greedy sampling shares its group loop across keys: AdaAtt takes
# the diverse beam only
@pytest.mark.parametrize('model,case', [
    (m, c) for m in MODELS for c in DIVERSE
    if (m, c) != ('adaatt', 'greedy_g2')])
def test_diverse_train_sampling_matches_jax(df_path, model, case):
    from captioning_tpu.engine import decoding as jdec
    from captioning_tpu.utils.misc import _flatten_tree
    from captioning_tpu_torch.utils.weights import jax_from_state_dict
    opt = DIVERSE[case]
    G = opt['group_size']
    both = Both(model, df_path, **BEAM)
    jcap, pcap = both.jcap, both.pt.captioner
    fc, att, am = both.jargs('fc', 'att', 'am')
    rng = jax.random.PRNGKey(3)
    n = fc.shape[0] * G
    r = np.random.RandomState(2)
    reward = r.randn(n, both.L).astype('float32')
    scores = r.rand(n).astype('float32')

    def jax_losses(variables):
        dm = jcap.bind(variables, train=True)
        seq, lp = jdec.sample(dm, fc, att, am, rng, opt)
        seq = jax.lax.stop_gradient(seq)
        lp_re = jdec.scan_logprobs(dm, fc, att, am, seq, rng, sample_n=G)
        ls = _losses(_Jax, lp, lp_re, seq, jnp.asarray(reward),
                     jnp.asarray(scores), G)
        return sum(ls), (seq, jnp.stack(ls))

    (_, (jseq, jls)), jgrad = jax.jit(jax.value_and_grad(
        jax_losses, has_aux=True))(jax.tree.map(jnp.asarray, both.variables))
    want = {k: v for k, v in _flatten_tree(
        jax.tree.map(np.asarray, jgrad)).items() if k.startswith('params/')}

    gen = torch.Generator().manual_seed(0)
    pfc, patt, pam = both.pargs('fc', 'att', 'am')
    seq, lp = pcap.sample_train(pfc, patt, pam, None, opt, gen)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    assert seq.shape == (n, both.L) and lp.requires_grad
    stats_seq, _ = pcap.sample_train(pfc, patt, pam, None, opt, gen,
                                     return_stats=True)
    np.testing.assert_array_equal(stats_seq.numpy(), seq.numpy())
    lp_re = pcap.scan_logprobs(pfc, patt, pam, seq, gen, G)
    ls = _losses(_Port, lp, lp_re, seq, torch.from_numpy(reward),
                 torch.from_numpy(scores), G)
    np.testing.assert_allclose([float(x.detach()) for x in ls], np.asarray(jls),
                               rtol=1e-5, atol=0)
    sum(ls).backward()
    got = jax_from_state_dict(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in pcap.module.named_parameters()}, pcap.cfg, True)
    check_grads(want, got)


def test_graph_route_names_the_train_beam(df_path):
    both = Both('updown', df_path, **BEAM)
    why = both.pt.graph_route('sc_fused')
    assert 'train_beam_size > 1' in why
    assert 'train_beam_size > 1' in both.pt.graph_route('struc_fused')
    assert both.pt.graph_route('sc_grad') == ''
    with pytest.raises(ValueError, match='train-mode beam'):
        both.pt.sc_fused_step_graphed(
            *both.pargs('fc', 'att', 'am', 'refs', 'ref_mask'), 1e-2, None,
            None, torch.Generator().manual_seed(0), both.psc)
