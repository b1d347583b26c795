"""The port's XE criterions (``modules/losses.py``) against the JAX
package on the same numpy log-probs, targets and masks (float32, CPU):
the masked LM NLL and the label-smoothed KL, each with 'mean' and 'none'
reduction, over [N, L] and [B, seq_per_img, L] targets (the criterions cut
the target to the log-probs' L).  atol 1e-6: the same float32 math up to
summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.modules import losses as jlosses
from captioning_tpu_torch.modules import losses as plosses

ATOL = 1e-6


def _case(seed, B=3, spi=4, L=6, V=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(B * spi, L, V).astype('float32')
    lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    target = rng.randint(0, V, (B, spi, L + 1)).astype('int32')
    mask = (rng.rand(B, spi, L + 1) < 0.7).astype('float32')
    mask[1, 2] = 0          # a caption with no valid token: its mean is 0
    return lp.astype('float32'), target, mask


@pytest.mark.parametrize('reduction', ['mean', 'none'])
@pytest.mark.parametrize('rank', [2, 3])
def test_language_model_criterion_matches_jax(reduction, rank):
    lp, target, mask = _case(rank)
    if rank == 2:
        target, mask = (a.reshape(-1, a.shape[-1]) for a in (target, mask))
    want = jlosses.language_model_criterion(
        jnp.asarray(lp), jnp.asarray(target), jnp.asarray(mask), reduction)
    got = plosses.language_model_criterion(
        torch.from_numpy(lp), torch.from_numpy(target).long(),
        torch.from_numpy(mask), reduction)
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize('reduction', ['mean', 'none'])
@pytest.mark.parametrize('rank', [2, 3])
@pytest.mark.parametrize('smoothing', [0.1, 0.5])
def test_label_smoothing_criterion_matches_jax(reduction, rank, smoothing):
    lp, target, mask = _case(10 + rank)
    if rank == 2:
        target, mask = (a.reshape(-1, a.shape[-1]) for a in (target, mask))
    want = jlosses.label_smoothing_criterion(
        jnp.asarray(lp), jnp.asarray(target), jnp.asarray(mask), smoothing,
        reduction)
    got = plosses.label_smoothing_criterion(
        torch.from_numpy(lp), torch.from_numpy(target).long(),
        torch.from_numpy(mask), smoothing, reduction)
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_label_smoothing_gradient_matches_jax():
    import jax
    lp, target, mask = _case(7)
    want = jax.grad(lambda x: jlosses.label_smoothing_criterion(
        x, jnp.asarray(target), jnp.asarray(mask), 0.2))(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_(True)
    plosses.label_smoothing_criterion(x, torch.from_numpy(target).long(),
                                      torch.from_numpy(mask), 0.2).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
