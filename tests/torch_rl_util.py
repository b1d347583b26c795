"""Shared set-up of the port's RL train-step parity tests: one tiny model
trained by the JAX ``Trainer`` and by the port's from the same weights, on
the same batch and references, with the JAX engine's sampling noise handed
to the port (``jax_draws``), float32 on the CPU."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import (V, inputs, jax_and_port, jax_draws,
                                   tiny_vocab, train_batch)
from tests.torch_train_util import model_opt

B, N_SAMPLE = 3, 3
# (model, options, old policy's seed) -> the JAX side (captioner, its
# variables, trainer, old variables): its trainer keeps its jitted steps,
# so the tests of one configuration compile each step once
_JAX_SIDES = {}


def rl_opt(model, **kw):
    """``model_opt`` with the RL steps' options: 3 samples a row by
    sampling against the greedy baseline, the CIDEr-D reward,
    new_self_critical at weight 1, PPO off, drop-worst's rate 0.5 (used
    only where a step is asked to drop); adam 1e-2 at dropout 0."""
    base = dict(train_sample_n=N_SAMPLE, train_sample_method='sample',
                drop_worst_rate=0.5,
                train_beam_size=1, sc_sample_method='greedy',
                sc_beam_size=1, cider_reward_weight=1.0,
                bleu_reward_weight=0.0, structure_loss_weight=1.0,
                structure_loss_type='new_self_critical',
                entropy_reward_weight=0.0, self_cider_reward_weight=0.0,
                use_ppo=0, ppo_cliprange=0.2, ppo_kl_coef=0.02,
                struc_use_logsoftmax=False)
    return model_opt(model, **dict(base, **kw))


def write_df(root, seed=0, images=30):
    """A df pickle as scripts/prepro_ngrams.py writes it, over random
    references of the tiny vocab: its path and (df, ref_len)."""
    rng = np.random.RandomState(seed)
    df = {}
    for _ in range(images):
        grams = set()
        for _ in range(3):
            toks = [str(t) for t in rng.randint(1, V, rng.randint(3, 7))]
            toks.append('0')
            for n in range(1, 5):
                grams.update(tuple(toks[k:k + n])
                             for k in range(len(toks) - n + 1))
        for g in grams:
            df[g] = df.get(g, 0.0) + 1.0
    path = os.path.join(str(root), 'rl-idxs.p')
    with open(path, 'wb') as f:
        pickle.dump({'document_frequency': df, 'ref_len': images}, f)
    return path, df, float(images)


def references(pcap, fc, att, am, seed=1):
    """gts (a list of [4, 7] arrays, the first the model's greedy caption
    so the rewards differ between samples), refs [B, 5, 7] and ref_mask
    [B, 5] as numpy."""
    from captioning_tpu_torch.ops.cider_device import pad_gts
    rng = np.random.RandomState(seed)
    greedy, _ = pcap.sample_stats(torch.from_numpy(fc), torch.from_numpy(att),
                                  torch.from_numpy(am), None,
                                  {'sample_method': 'greedy',
                                   'beam_size': 1})
    gts = []
    for b in range(fc.shape[0]):
        g = rng.randint(1, V, (4, 7))
        g[0, :6] = greedy[b, :6].numpy()
        g[:, -1] = 0
        gts.append(g)
    refs, mask = pad_gts(gts, pad_to_multiple=5)
    return gts, refs, mask


class Both:
    """The JAX and port sides of one model: captioners, trainers,
    scorers, the batch and its references; the port side fresh, the JAX
    side (functional) shared by the tests of one configuration."""

    def __init__(self, model, df_path, old_seed=None, **kw):
        from captioning_tpu.modules.trainer import Trainer as JaxTrainer
        from captioning_tpu.ops.cider_device import DeviceCiderD as JaxCiderD
        from captioning_tpu_torch.modules.trainer import Trainer
        from captioning_tpu_torch.ops.cider_device import DeviceCiderD
        from captioning_tpu_torch.models.api import setup
        from captioning_tpu_torch.utils import rewards
        key = (model, old_seed, tuple(sorted(kw.items())))
        if key not in _JAX_SIDES:
            opt = rl_opt(model, **kw)
            jcap, variables, _ = jax_and_port(opt=opt)
            old_variables = None
            if old_seed is not None:
                _, old_variables, _ = jax_and_port(seed=old_seed, opt=opt)
            _JAX_SIDES[key] = (opt, jcap, variables, old_variables,
                               JaxTrainer(jcap, opt,
                                          old_variables=old_variables))
        (self.opt, self.jcap, self.variables, old_variables,
         self.jt) = _JAX_SIDES[key]
        opt = self.opt

        def port(variables):
            return setup(opt, tiny_vocab(), device='cpu').load_jax_variables(
                variables)
        self.pcap = port(self.variables)
        old_captioner = None if old_variables is None else port(
            old_variables)
        self.pt = Trainer(self.pcap, opt, old_captioner=old_captioner)
        self.state = self.jt.init_opt_state(self.variables)
        self.jsc = JaxCiderD(df_path)
        self.psc = DeviceCiderD(df_path, device='cpu')
        rewards.CiderD_scorer = rewards.Cider_scorer = None
        rewards.Bleu_scorer = None
        rewards.init_scorer(df_path)
        self.fc, self.att, self.am = inputs(B)
        self.gts, self.refs, self.ref_mask = references(
            self.pcap, self.fc, self.att, self.am)
        self.labels, self.masks = train_batch(B, N_SAMPLE)
        self.L = self.pcap.cfg.seq_length

    def jargs(self, *names):
        return [jnp.asarray(np.asarray(
            getattr(self, n), np.int32 if n in ('labels', 'refs')
            else None)) for n in names]

    def pargs(self, *names):
        return [torch.from_numpy(np.asarray(getattr(self, n)))
                for n in names]

    def draws(self, seed):
        """(the JAX rng, the port's draw of the same noise)."""
        return jax.random.PRNGKey(seed), jax_draws(seed, self.L)


def check_trajectory(want, got):
    """The first loss within 1e-5 relative, the trajectory within 1e-4."""
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def bn_stats(pcap):
    """The port's BatchNorm running statistics in the JAX layout."""
    from captioning_tpu.utils.misc import _flatten_tree
    return _flatten_tree(pcap.jax_variables()).items()


def check_bn(variables, pcap):
    """The port's running statistics equal the JAX variables' within
    1e-6."""
    from captioning_tpu.utils.misc import _flatten_tree
    want = _flatten_tree(jax.tree.map(np.asarray,
                                      {'batch_stats':
                                       variables['batch_stats']}))
    got = {k: v for k, v in bn_stats(pcap) if k.startswith('batch_stats')}
    assert sorted(got) == sorted(want) and want
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=1e-6, rtol=0,
                                   err_msg=key)
