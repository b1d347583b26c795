"""Shared set-up of the port's bf16 training tests
(``test_torch_train_bf16*.py``): the JAX ``Trainer`` and the port's at
``compute_dtype='bfloat16'`` from the same weights, their first step's
gradients and the bound that holds one against the other."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from captioning_tpu_torch.models.api import setup
from captioning_tpu_torch.modules.trainer import Trainer
from tests.torch_port_util import (inputs, jax_and_port, tiny_vocab,
                                   train_batch)
from tests.torch_rl_util import rl_opt

BF16 = dict(compute_dtype='bfloat16', grad_clip_value=0)
MU = '#1/#0/#1/'          # adam's first moment in the optax layout


def flat(tree):
    from captioning_tpu.utils.misc import _flatten_tree
    return _flatten_tree(jax.tree.map(np.asarray, tree))


def port_grads(pt):
    """The port's gradients of the last step, in the JAX layout."""
    from captioning_tpu_torch.utils.weights import jax_from_state_dict
    return {k[len('params/'):]: v for k, v in jax_from_state_dict(
        {n: p.grad.clone() for n, p in pt.named_params.items()},
        pt.captioner.cfg, True).items()}


def jax_grads(state):
    """The first step's gradients from adam's first moment (1 - b1) g."""
    return {k[len(MU):]: v / np.float32(0.1) for k, v in flat(state).items()
            if k.startswith(MU)}


def check_bf16(got, want16, want32, what, far=True):
    """Each tensor of ``got`` within 2e-2 of ``want16`` in relative L2,
    plus twice its bf16-to-float32 distance, plus 1e-4 of the largest
    tensor's norm (a gradient that is 0 in exact arithmetic, such as the
    attention logit's bias, is rounding noise on either side); with
    ``far``, the whole at least a quarter of the bf16-to-float32 distance
    from ``want32``."""
    assert sorted(got) == sorted(want16) == sorted(want32)
    scale = max(np.linalg.norm(np.asarray(w, np.float64))
                for w in want16.values())
    dist, noise = 0.0, 0.0
    for k in sorted(got):
        g, w16, w32 = (np.asarray(x, np.float64)
                       for x in (got[k], want16[k], want32[k]))
        floor = np.linalg.norm(w16 - w32)
        err = np.linalg.norm(g - w16)
        assert err <= (2e-2 * np.linalg.norm(w16) + 2 * floor
                       + 1e-4 * scale), (
            '%s %s: %.3g against %.3g (bf16 noise %.3g)'
            % (what, k, err, np.linalg.norm(w16), floor))
        dist += np.sum((g - w32) ** 2)
        noise += np.sum((w16 - w32) ** 2)
    if far:
        assert np.sqrt(dist) >= 0.25 * np.sqrt(noise) > 0, what


def all_float32(pt):
    """Every parameter, gradient and optimizer moment of ``pt`` float32."""
    for n, p in pt.named_params.items():
        assert p.dtype == p.grad.dtype == torch.float32, n
        for key, v in pt.optimizer.state[p].items():
            if key != 'step':
                assert v.dtype == torch.float32, (n, key)


def xe_run(opt, steps=3):
    """(losses, the first step's gradients, the optimizer state) of the
    JAX trainer, and the port's (its trainer too)."""
    from captioning_tpu.modules.trainer import Trainer as JaxTrainer
    jcap, variables, pcap = jax_and_port(opt=opt)
    fc, att, am = inputs(4)
    labels, masks = train_batch(4, 5)
    jt, pt = JaxTrainer(jcap, opt), Trainer(pcap, opt)
    state = jt.init_opt_state(variables)
    jargs = [jnp.asarray(a) for a in (fc, att, labels.astype('int32'), masks,
                                      am)]
    pargs = [torch.from_numpy(a) for a in (fc, att, labels, masks, am)]
    jl, pl, jg, pg = [], [], None, None
    for step in range(steps):
        variables, state, out = jt.xe_step(
            variables, state, *jargs, 1e-2, 0.0, jax.random.PRNGKey(step))
        jl.append(float(out['loss']))
        pl.append(float(pt.xe_step(*pargs, 1e-2, 0.0,
                                   torch.Generator().manual_seed(step))
                        ['loss']))
        if step == 0:
            jg, pg = jax_grads(state), port_grads(pt)
    return (jl, jg, flat(state)), (pl, pg, pt)


def bf16_trainer(model, seed=0, **kw):
    """A bf16 port trainer at the RL options, dropout on, from the port's
    own init."""
    opt = rl_opt(model, **dict(dict(drop_prob_lm=0.3, dropout=0.2,
                                    compute_dtype='bfloat16'), **kw))
    cap = setup(opt, tiny_vocab(), 'cpu').init_params(
        torch.Generator().manual_seed(seed))
    return Trainer(cap, opt)


def report(model):
    """Print, for ``model``'s first bf16 XE step, each gradient's relative
    L2 distance from the JAX bf16 one (port~j16), from the JAX float32 one
    (port~j32), the JAX pair's own distance (j16~j32) and the error over
    ``check_bf16``'s bound.  ``python -m tests.torch_bf16_util
    <model>``."""
    from tests.torch_train_util import model_opt
    if model == 'aoa':
        from captioning_tpu.models import aoa as jaoa
        from captioning_tpu.models.layers import Dropout
        from captioning_tpu_torch.models import aoa as paoa
        jaoa.Dropout = lambda rate: Dropout(0.0)
        paoa.DROPOUT = 0.0
    j16, (pl, pg, _) = xe_run(model_opt(model, **BF16), steps=1)
    j32, _ = xe_run(model_opt(model, grad_clip_value=0), steps=1)
    print('%s loss: port %.6f, JAX bf16 %.6f, JAX float32 %.6f'
          % (model, pl[0], j16[0][0], j32[0][0]))
    scale = max(np.linalg.norm(w) for w in j16[1].values())

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    for k in sorted(pg):
        g, w16, w32 = (np.asarray(x, np.float64)
                       for x in (pg[k], j16[1][k], j32[1][k]))
        bound = (2e-2 * np.linalg.norm(w16) + 2 * np.linalg.norm(w16 - w32)
                 + 1e-4 * scale)
        print('  %-40s port~j16 %.2e port~j32 %.2e j16~j32 %.2e '
              'err/bound %.3f' % (k, rel(g, w16), rel(g, w32),
                                  rel(w16, w32),
                                  np.linalg.norm(g - w16) / bound))


if __name__ == '__main__':
    import sys
    for name in sys.argv[1:]:
        report(name)
