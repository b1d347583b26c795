"""The port's RL criterions (``modules/losses.py``) against the JAX
package's, on the CPU in float32: ``reward_criterion``, every
``structure_loss`` type with both reductions, its entropy and self-CIDEr
terms, ``ppo_loss`` (the clip and the KL to the old policy) and
``masked_mean``; each value within 1e-6 and its gradient with respect to
the log-probs (logits for the margin losses) within 1e-5 of
``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

B, N_SEQ, L, V = 3, 4, 6, 9            # 3 images x 4 samples
TYPES = ('seqnll', 'risk', 'max_margin', 'multi_margin', 'softmax_margin',
         'real_softmax_margin', 'new_self_critical', 'best_of_n')


def _inputs(seed):
    """log-probs [N, L, V], logits, seq [N, L] (rows that end early, one
    that never ends), scores [N] with a tie, self-CIDEr scores [B]."""
    rng = np.random.RandomState(seed)
    N = B * N_SEQ
    logits = rng.randn(N, L, V).astype('float32') * 2
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    seq = rng.randint(1, V, (N, L))
    lengths = rng.randint(1, L + 1, N)
    lengths[0] = L
    seq = np.where(np.arange(L) < lengths[:, None], seq, 0)
    scores = rng.rand(N).astype('float32')
    scores[5] = scores[4]
    self_cider = rng.rand(B).astype('float32')
    return logits, lp.astype('float32'), seq, scores, self_cider


def _check(jax_fn, port_fn, x, key='loss'):
    """Value and gradient (of the sum of ``key``) with respect to ``x``."""
    want = jax_fn(jnp.asarray(x))
    want_g = jax.grad(lambda v: jax_fn(v)[key].sum())(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = port_fn(xt)
    got[key].sum().backward()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w),
                                   atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize('reduction', ['mean', 'none'])
def test_reward_criterion_matches_jax(reduction):
    from captioning_tpu.modules import losses as jl
    from captioning_tpu_torch.modules import losses as pl
    _, lp, seq, scores, _ = _inputs(0)
    reward = np.repeat(scores[:, None] - 0.5, L, 1)
    _check(lambda x: {'loss': jl.reward_criterion(
               x, jnp.asarray(seq), jnp.asarray(reward), reduction)},
           lambda x: {'loss': pl.reward_criterion(
               x, torch.from_numpy(seq), torch.from_numpy(reward),
               reduction)}, lp)


@pytest.mark.parametrize('loss_type', TYPES)
@pytest.mark.parametrize('reduction', ['mean', 'none'])
def test_structure_loss_matches_jax(loss_type, reduction):
    """Every type and both reductions (the ones without a per-sequence
    form reduce to the mean either way, as in JAX); the margin losses over
    logits."""
    from captioning_tpu.modules import losses as jl
    from captioning_tpu_torch.modules import losses as pl
    logits, lp, seq, scores, _ = _inputs(1)
    x = logits if 'margin' in loss_type else lp
    _check(lambda v: jl.structure_loss(v, jnp.asarray(seq),
                                       jnp.asarray(scores), loss_type,
                                       N_SEQ, reduction=reduction),
           lambda v: pl.structure_loss(v, torch.from_numpy(seq),
                                       torch.from_numpy(scores), loss_type,
                                       N_SEQ, reduction=reduction), x)


@pytest.mark.parametrize('loss_type', ['new_self_critical', 'seqnll',
                                       'softmax_margin'])
def test_structure_loss_entropy_and_self_cider_terms_match_jax(loss_type):
    """The entropy reward (taking no gradient) and, for new_self_critical,
    the self-CIDEr diversity term added to the advantage."""
    from captioning_tpu.modules import losses as jl
    from captioning_tpu_torch.modules import losses as pl
    logits, lp, seq, scores, self_cider = _inputs(2)
    x = logits if 'margin' in loss_type else lp
    kw = dict(entropy_reward_weight=0.3, self_cider_weight=0.7)
    _check(lambda v: jl.structure_loss(
               v, jnp.asarray(seq), jnp.asarray(scores), loss_type, N_SEQ,
               self_cider_scores=jnp.asarray(self_cider), **kw),
           lambda v: pl.structure_loss(
               v, torch.from_numpy(seq), torch.from_numpy(scores),
               loss_type, N_SEQ,
               self_cider_scores=torch.from_numpy(self_cider), **kw), x)


def test_unknown_structure_loss_raises():
    from captioning_tpu_torch.modules import losses as pl
    _, lp, seq, scores, _ = _inputs(0)
    with pytest.raises(ValueError, match='unknown structure_loss_type'):
        pl.structure_loss(torch.from_numpy(lp), torch.from_numpy(seq),
                          torch.from_numpy(scores), 'nope', N_SEQ)


@pytest.mark.parametrize('reduction', ['mean', 'none'])
@pytest.mark.parametrize('cliprange,shift', [(0.2, 0.3), (0.05, 1.0)],
                         ids=['clip0.2', 'clip0.05'])
def test_ppo_loss_matches_jax(reduction, cliprange, shift):
    """clip-PPO and the KL to the old policy, whose table takes no
    gradient; the old policy shifted so ratios leave the clip range (the
    clip fraction is not 0)."""
    from captioning_tpu.modules import losses as jl
    from captioning_tpu_torch.modules import losses as pl
    logits, lp, seq, scores, _ = _inputs(3)
    rng = np.random.RandomState(4)
    old = logits + shift * rng.randn(*logits.shape).astype('float32')
    old = (old - np.log(np.exp(old).sum(-1, keepdims=True))).astype(
        'float32')
    kw = dict(cliprange=cliprange, kl_coef=0.05, reduction=reduction)
    want = jl.ppo_loss(jnp.asarray(lp), jnp.asarray(old), jnp.asarray(seq),
                       jnp.asarray(scores), N_SEQ, **kw)
    assert float(want['clipfrac']) > 0
    _check(lambda v: jl.ppo_loss(v, jnp.asarray(old), jnp.asarray(seq),
                                 jnp.asarray(scores), N_SEQ, **kw),
           lambda v: pl.ppo_loss(v, torch.from_numpy(old),
                                 torch.from_numpy(seq),
                                 torch.from_numpy(scores), N_SEQ, **kw), lp)


@pytest.mark.parametrize('axis', [None, 1])
def test_masked_mean_matches_jax(axis):
    from captioning_tpu.modules import losses as jl
    from captioning_tpu_torch.modules import losses as pl
    _, lp, seq, _, _ = _inputs(5)
    mask = (seq > 0).astype('float32')
    mask[2] = 0
    x = lp[..., 0]
    want = jl.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis)
    got = pl.masked_mean(torch.from_numpy(x), torch.from_numpy(mask), axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
