"""Shared set-up of the port's XE train-step parity tests: one model
trained a few XE steps by the JAX ``Trainer`` and by the port's, from the
same weights on the same batch (float32, CPU, dropout 0, ss_prob 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import (inputs, jax_and_port, tiny_aoa_opt,
                                   tiny_opt, tiny_rnn_opt, train_batch,
                                   train_opt)


def model_opt(model, **kw):
    opt = (tiny_opt(caption_model=model)
           if model in ('transformer', 'bert', 'm2transformer') else
           tiny_aoa_opt() if model == 'aoa' else tiny_rnn_opt(model))
    return train_opt(opt, **kw)


def run_both(opt, steps=3, spi=5, lr=1e-2, drop_worst=False, ss_prob=0.0,
             eos_boost=0.0):
    """(JAX losses, port losses, JAX variables, JAX optax state, port
    captioner, port trainer) after ``steps`` XE steps on one batch, at
    ``ss_prob`` (``eos_boost`` raises the EOS logit bias, so that a
    scheduled-sampling draw is EOS on both sides)."""
    from captioning_tpu.modules.trainer import Trainer as JaxTrainer
    from captioning_tpu_torch.modules.trainer import Trainer
    jcap, variables, pcap = jax_and_port(opt=opt, eos_boost=eos_boost)
    B = 4
    fc, att, am = inputs(B)
    labels, masks = train_batch(B, spi)
    jt, pt = JaxTrainer(jcap, opt), Trainer(pcap, opt)
    state = jt.init_opt_state(variables)
    jargs = [jnp.asarray(a) for a in (fc, att, labels.astype('int32'), masks,
                                      am)]
    pargs = [torch.from_numpy(a) for a in (fc, att, labels, masks, am)]
    want, got = [], []
    for step in range(steps):
        variables, state, out = jt.xe_step(
            variables, state, *jargs, lr, ss_prob, jax.random.PRNGKey(step),
            drop_worst_flag=drop_worst)
        want.append(float(out['loss']))
        got.append(float(pt.xe_step(*pargs, lr, ss_prob,
                                    torch.Generator().manual_seed(step),
                                    drop_worst_flag=drop_worst)['loss']))
    return want, got, variables, state, pcap, pt


def check_losses(want, got):
    """The first loss within 1e-5 relative, the trajectory within 1e-4."""
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]               # the steps trained


def check_opt_state(state, pt):
    """The port's optimizer state in the JAX layout within 1e-6."""
    from captioning_tpu.utils.misc import _flatten_tree
    want = _flatten_tree(jax.tree.map(np.asarray, state))
    got = pt.opt_state_jax()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=1e-6, rtol=0,
                                   err_msg=key)
