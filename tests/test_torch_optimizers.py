"""The port's optimizers (``utils/optimizers.py``) against the JAX chain the
JAX trainer builds (``optax.chain(clip_transform, build_optimizer)``, or
the noam optimizer), float32 on the CPU: 5 steps on identical gradients
with the learning rate injected per step, for the seven ``--optim`` values
with and without weight decay, noam adam / adamw, and clip by value, by
global norm and none.  The optimizer state maps to the JAX package's
``optimizer.npz`` layout both ways: after the steps ``state_to_jax`` gives
the JAX state's keys, shapes, dtypes and values, and a port optimizer
loaded from that state takes a sixth step equal to JAX's.  atol 1e-6 on
parameters of an init's scale (N(0, 0.25^2), where a float32 ulp is below
6e-8): the same float32 updates up to operation order (torch's norm clip
divides by norm + 1e-6, optax by the norm) and one difference of precision:
optax forms Adam's bias corrections in float32 (1 - 0.999 is off by 1.3e-5
relative there), torch in double, so an Adam update differs by up to ~7e-6
relative.  The rates (0.01 down to 0.001) keep the 5 steps' sum of that
below 1e-6; they are still 2-20x the configs' 5e-4."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from captioning_tpu.utils import optimizers as jopt
from captioning_tpu.utils.misc import _flatten_tree
from captioning_tpu_torch.models.config import ModelConfig
from captioning_tpu_torch.utils import optimizers as popt

ATOL = 1e-6
LRS = [0.01, 0.008, 0.006, 0.004, 0.002, 0.001]
OPTIMS = ['rmsprop', 'adagrad', 'sgd', 'sgdm', 'sgdmom', 'adam', 'adamw']
# a model of the port whose parameters are {logit.weight, logit.bias,
# embed.embedding, ...}: the optimizer state's paths go through the weight
# bridge as the trainer's do
CFG = ModelConfig(caption_model='newfc', vocab_size=6, input_encoding_size=4,
                  rnn_size=3, fc_feat_size=5, att_hid_size=2)


def _opt(name, wd, clip, noam=False):
    return SimpleNamespace(
        optim=name, optim_alpha=0.9, optim_beta=0.999, optim_epsilon=1e-8,
        weight_decay=wd, learning_rate=LRS[0], noamopt=noam,
        grad_clip_mode='value' if clip == 'value' else 'norm',
        grad_clip_value=0.0 if clip == 'none' else 0.3)


def _params_and_grads(seed, steps=6):
    """The port's newfc parameters (by name) and per-step gradients, some
    above the clip value and a global norm above the clip norm."""
    from captioning_tpu_torch.models.harness import AttCaptioner
    rng = np.random.RandomState(seed)
    shapes = {k: tuple(v.shape)
              for k, v in AttCaptioner(CFG).named_parameters()}
    p0 = {k: (rng.randn(*s) * 0.25).astype('float32')
          for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 0.2).astype('float32')
              for k, s in shapes.items()} for _ in range(steps)]
    return p0, grads


def _jax_tree(flat_port):
    """{port name: array} -> the JAX params tree (through the bridge)."""
    from captioning_tpu_torch.utils.misc import _unflatten_tree
    from captioning_tpu_torch.utils.weights import jax_from_state_dict
    flat = jax_from_state_dict({k: torch.from_numpy(v)
                                for k, v in flat_port.items()}, CFG, True)
    return jax.tree.map(jnp.asarray, _unflatten_tree(flat)['params'])


def _run_jax(opt, p0, grads):
    tx = optax.chain(jopt.clip_transform(opt),
                     jopt.build_noam_optimizer(opt) if opt.noamopt
                     else jopt.build_optimizer(opt))
    p = _jax_tree(p0)
    state = tx.init(p)
    for g, lr in zip(grads, LRS):
        u, state = tx.update(_jax_tree(g), state, p)
        # trainer._apply_updates: params += -lr * update
        p = jax.tree.map(lambda a, b: a - lr * b, p, u)
    return p, state


def _port(opt, p0):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    build = popt.build_noam_optimizer if opt.noamopt else popt.build_optimizer
    return params, build(opt, list(params.values()))


def _step_port(opt, params, optimizer, g, lr):
    for k, p in params.items():
        p.grad = torch.from_numpy(g[k].copy())
    popt.clip_transform(opt)(list(params.values()))
    popt.set_lr(optimizer, lr)
    optimizer.step()


def _check(opt, seed):
    p0, grads = _params_and_grads(seed)
    want_p, want_state = _run_jax(opt, p0, grads[:5])
    params, optimizer = _port(opt, p0)
    for g, lr in zip(grads[:5], LRS):
        _step_port(opt, params, optimizer, g, lr)
    got_p = _jax_tree({k: v.detach().numpy() for k, v in params.items()})
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_p),
                            jax.tree.leaves(got_p)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=str(path))

    # the state in the JAX layout, both ways
    want_flat = _flatten_tree(jax.tree.map(np.asarray, want_state))
    got_flat = popt.state_to_jax(optimizer, opt, params, CFG)
    assert sorted(got_flat) == sorted(want_flat)
    for key, w in want_flat.items():
        assert got_flat[key].dtype == w.dtype and got_flat[key].shape == \
            w.shape, key
        np.testing.assert_allclose(got_flat[key], w, atol=ATOL, rtol=1e-6,
                                   err_msg=key)
    # a fresh port optimizer loaded from the JAX state steps as JAX does
    tx = optax.chain(jopt.clip_transform(opt),
                     jopt.build_noam_optimizer(opt) if opt.noamopt
                     else jopt.build_optimizer(opt))
    u, _ = tx.update(_jax_tree(grads[5]), want_state, want_p)
    want6 = jax.tree.map(lambda a, b: a - LRS[5] * b, want_p, u)
    flat_p = {k: np.asarray(v) for k, v in _port_state_dict(want_p).items()}
    params2, optimizer2 = _port(opt, flat_p)
    popt.state_from_jax(optimizer2, opt, params2, CFG, want_flat)
    _step_port(opt, params2, optimizer2, grads[5], LRS[5])
    got6 = _jax_tree({k: v.detach().numpy() for k, v in params2.items()})
    for w, g in zip(jax.tree.leaves(want6), jax.tree.leaves(got6)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL,
                                   rtol=0)


def _port_state_dict(jax_params):
    from captioning_tpu_torch.utils.weights import state_dict_from_jax
    return {k: v.numpy() for k, v in state_dict_from_jax(
        {'params': jax.tree.map(np.asarray, jax_params)}, CFG,
        params_only=True).items()}


@pytest.mark.parametrize('clip', ['value', 'norm', 'none'])
@pytest.mark.parametrize('wd', [0.0, 0.01])
@pytest.mark.parametrize('name', OPTIMS)
def test_optimizer_matches_jax_chain(name, wd, clip):
    _check(_opt(name, wd, clip), seed=OPTIMS.index(name))


@pytest.mark.parametrize('clip', ['value', 'norm'])
@pytest.mark.parametrize('name', ['adam', 'adamw'])
def test_noam_optimizer_matches_jax_chain(name, clip):
    _check(_opt(name, 0.0, clip, noam=True), seed=7)


def test_state_from_jax_rejects_another_layout():
    p0, grads = _params_and_grads(0)
    _, state = _run_jax(_opt('adam', 0.01, 'value'), p0, grads[:1])
    params, optimizer = _port(_opt('adam', 0.0, 'value'), p0)
    with pytest.raises(KeyError, match='layout'):
        popt.state_from_jax(optimizer, _opt('adam', 0.0, 'value'), params,
                            CFG, _flatten_tree(jax.tree.map(np.asarray,
                                                            state)))


def test_unknown_optimizers_raise():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(Exception, match='bad option'):
        popt.build_optimizer(_opt('lamb', 0.0, 'none'), p)
    with pytest.raises(KeyError, match='noamopt'):
        popt.build_noam_optimizer(_opt('sgd', 0.0, 'none', True), p)
