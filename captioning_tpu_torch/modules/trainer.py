"""The train steps: XE, SCST, and the structure losses with PPO.

Port of ``captioning_tpu/modules/trainer.py``.  The JAX trainer is
functional (variables and optax state in, updated copies out, one jitted
program a step); here the captioner's parameters, its BatchNorm statistics
and the ``torch.optim`` state are updated in place.  ``opt_state_jax`` /
``load_opt_state_jax`` carry the optimizer state in the JAX package's
``optimizer.npz`` layout.

The RL steps come in two forms, as in the JAX package.  The fused ones
(``sc_fused_step``, ``struc_fused_step``) sample, score on the card
(``ops/cider_device.py``) and differentiate the sampling pass itself.  The
unfused ones decode (``sc_decode``, ``struc_decode``), leave the scoring to
the host (``utils/rewards.py``, ``utils/cider_native.py``) and recompute
the sampled sequence's distributions in the grad step (``sc_grad_step``,
``struc_grad_step``).  Randomness:

* the sampling noise comes from its own ``rng`` (a generator or a
  ``draw`` callable, ``engine.decoding``);
* dropout comes from ``generator``, the train switch.  A decode draws from
  a copy and leaves ``generator`` as it found it, so the grad step, handed
  the same generator, draws the same masks in the same order (prepare,
  then each step) and recomputes the sampling pass's activations exactly;
* the structure steps' XE term draws from its own ``generator_lm``.

BatchNorm running statistics change once a step, from the sampling pass's
train-mode prepare, as the JAX steps thread them: the eval greedy baseline
reads them, and the XE term and the recompute run under
``Captioner.bn_frozen``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..engine import decoding
from ..utils import optimizers as optim_utils
from . import losses


def _copy(generator: torch.Generator) -> torch.Generator:
    """A generator on the same device in the same state."""
    g = torch.Generator(generator.device)
    g.set_state(generator.get_state())
    return g


class Trainer:
    """The train steps of ``captioner`` with ``opt``'s optimizer;
    ``old_captioner`` is PPO's frozen old policy (eval, no graph)."""

    def __init__(self, captioner, opt, old_captioner=None):
        self.captioner = captioner.trainable()
        self.opt = opt
        self.old_captioner = old_captioner
        # whether the structure steps' sampling pass outputs log-softmaxed
        # tables (loss_wrapper.py:31-37): the margin losses take logits;
        # shared by the fused, decode and grad paths
        self.struc_out_ls = int(
            getattr(opt, 'struc_use_logsoftmax', False) or
            getattr(opt, 'structure_loss_type', '') == 'softmax_margin' or
            'margin' not in getattr(opt, 'structure_loss_type', ''))
        self.label_smoothing = float(getattr(opt, 'label_smoothing', 0) or 0)
        self.named_params = dict(captioner.module.named_parameters())
        params = list(self.named_params.values())
        if getattr(opt, 'noamopt', False):
            self.optimizer = optim_utils.build_noam_optimizer(opt, params)
        else:
            self.optimizer = optim_utils.build_optimizer(opt, params)
        self.clip = optim_utils.clip_transform(opt)

    # -- optimizer state in the JAX layout ----------------------------------
    def opt_state_jax(self) -> Dict:
        return optim_utils.state_to_jax(self.optimizer, self.opt,
                                        self.named_params,
                                        self.captioner.cfg)

    def load_opt_state_jax(self, flat) -> None:
        optim_utils.state_from_jax(self.optimizer, self.opt,
                                   self.named_params, self.captioner.cfg,
                                   flat)

    # -- plumbing -----------------------------------------------------------
    def _apply_updates(self, loss, lr):
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # a parameter the pass does not reach (the folded cross-attention's
        # K bias in the transformer's decode step) takes a zero gradient,
        # as jax.grad gives it, so the optimizer steps it as the JAX one
        for p in self.named_params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip(list(self.named_params.values()))
        optim_utils.set_lr(self.optimizer, lr)
        self.optimizer.step()

    def _crit(self, logprobs, target, mask, reduction):
        if self.label_smoothing > 0:
            return losses.label_smoothing_criterion(
                logprobs, target, mask, self.label_smoothing, reduction)
        return losses.language_model_criterion(logprobs, target, mask,
                                               reduction)

    @staticmethod
    def _drop_worst(loss_vec, drop_worst_rate):
        """The mean of the k = int(N * (1 - rate)) smallest losses."""
        k = int(loss_vec.shape[0] * (1 - drop_worst_rate))
        return torch.topk(loss_vec, k, largest=False).values.mean()

    # -- XE -----------------------------------------------------------------
    def xe_step(self, fc, att, labels, masks, am, lr, ss_prob, generator,
                drop_worst_flag=False):
        """One XE step on a batch (labels / masks [B, seq_per_img, L + 2]
        or [N, L + 2]); dropout and scheduled sampling draw from
        ``generator``.  Returns {'loss': the loss before the update, a 0-d
        tensor on the device}."""
        logprobs = self.captioner.forward_tf(
            fc, att, labels[..., :-1], am, train=True, ss_prob=ss_prob,
            generator=generator)
        loss = self._crit(logprobs, labels[..., 1:], masks[..., 1:],
                          'none' if drop_worst_flag else 'mean')
        if drop_worst_flag:
            loss = self._drop_worst(
                loss, float(getattr(self.opt, 'drop_worst_rate', 0)))
        self._apply_updates(loss, lr)
        return {'loss': loss.detach()}

    # -- options of the RL passes -------------------------------------------
    def _sc_opt(self):
        """The greedy baseline's decode (loss_wrapper.py:57-62)."""
        return {'sample_method': self.opt.sc_sample_method,
                'beam_size': self.opt.sc_beam_size}

    def _train_opt(self, output_logsoftmax=1):
        """The sampling pass's decode (loss_wrapper.py:64-68)."""
        return {'sample_method': self.opt.train_sample_method,
                'beam_size': self.opt.train_beam_size,
                'sample_n': self.opt.train_sample_n,
                'output_logsoftmax': output_logsoftmax}

    def _reward_weights(self):
        return (float(self.opt.cider_reward_weight),
                float(getattr(self.opt, 'bleu_reward_weight', 0)))

    def _greedy(self, fc, att, am, rng):
        """The eval-mode baseline: int tokens, copied out of inference
        mode."""
        with torch.inference_mode():
            seq, _ = decoding.sample(self.captioner.bind(), fc, att, am, rng,
                                     self._sc_opt(), return_stats=True)
        return seq.clone()

    def _recompute(self, fc, att, am, gen_seq, generator,
                   output_logsoftmax=1):
        """The sampling pass's tables over ``gen_seq``, with the autograd
        graph, dropout from ``generator``, the BN statistics kept."""
        with self.captioner.bn_frozen():
            return self.captioner.scan_logprobs(
                fc, att, am, gen_seq, generator,
                int(self.opt.train_sample_n), output_logsoftmax)

    def _lm_loss(self, fc, att, labels, masks, am, generator_lm, reduction):
        """The structure steps' XE term (ss_prob 0; BN statistics kept),
        or 0 at structure_loss_weight 1."""
        if float(self.opt.structure_loss_weight) >= 1:
            return torch.zeros((), device=self.captioner.device)
        with self.captioner.bn_frozen():
            logprobs = self.captioner.forward_tf(
                fc, att, labels[..., :-1], am, train=True, ss_prob=0.0,
                generator=generator_lm)
        return self._crit(logprobs, labels[..., 1:], masks[..., 1:],
                          reduction)

    def _old_logprobs(self, fc, att, am, gen_seq):
        """PPO's old policy over ``gen_seq``: eval mode, no graph."""
        return self.old_captioner.scan_logprobs(
            fc, att, am, gen_seq, None, int(self.opt.train_sample_n)).clone()

    def _struc(self, lp, lp_old, gen_seq, scores, self_cider_scores,
               reduction):
        opt = self.opt
        sample_n = int(opt.train_sample_n)
        if int(getattr(opt, 'use_ppo', 0)):
            return losses.ppo_loss(lp, lp_old, gen_seq, scores, sample_n,
                                   cliprange=float(opt.ppo_cliprange),
                                   kl_coef=float(opt.ppo_kl_coef),
                                   reduction=reduction)
        return losses.structure_loss(
            lp, gen_seq, scores, opt.structure_loss_type, sample_n,
            entropy_reward_weight=float(
                getattr(opt, 'entropy_reward_weight', 0)),
            self_cider_scores=self_cider_scores,
            self_cider_weight=float(
                getattr(opt, 'self_cider_reward_weight', 0)),
            reduction=reduction)

    # -- SCST -----------------------------------------------------------------
    def sc_decode(self, fc, att, am, rng_greedy, rng_sample, generator):
        """The greedy baseline (eval) and ``train_sample_n`` samples a row
        (train mode), neither differentiated: (greedy_seq [B, L], gen_seq
        [B*n, L]).  Dropout is drawn from a copy of ``generator``, which
        ``sc_grad_step`` then draws again."""
        greedy_seq = self._greedy(fc, att, am, rng_greedy)
        gen_seq, _ = self.captioner.sample_train(
            fc, att, am, rng_sample, self._train_opt(), _copy(generator),
            return_stats=True)
        return greedy_seq, gen_seq

    def sc_grad_step(self, fc, att, am, gen_seq, reward, lr, generator,
                     drop_worst_flag=False):
        """The policy gradient over ``sc_decode``'s samples, their tables
        recomputed with the decode's dropout; ``reward`` [B*n, L].
        Returns {'loss'}."""
        lp = self._recompute(fc, att, am, gen_seq, generator)
        loss = losses.reward_criterion(
            lp, gen_seq, reward, 'none' if drop_worst_flag else 'mean')
        if drop_worst_flag:
            loss = self._drop_worst(
                loss, float(getattr(self.opt, 'drop_worst_rate', 0)))
        self._apply_updates(loss, lr)
        return {'loss': loss.detach()}

    def sc_fused_step(self, fc, att, am, refs, ref_mask, lr, rng_greedy,
                      rng_sample, generator, device_scorer):
        """One SCST iteration on the card: the greedy baseline, the
        sampling pass, the mixed reward (cider_reward_weight * CIDEr-D +
        bleu_reward_weight * BLEU-4 on ``device_scorer``; refs [B, R, Lr],
        ref_mask [B, R]) and the policy gradient through the sampling
        pass's own tables.  Returns {'loss', 'reward': the mean
        advantage}, on the device."""
        greedy_seq = self._greedy(fc, att, am, rng_greedy)
        gen_seq, gen_lp = self.captioner.sample_train(
            fc, att, am, rng_sample, self._train_opt(), generator)
        with torch.no_grad():
            reward = device_scorer.self_critical_reward(
                greedy_seq, gen_seq, refs, ref_mask,
                *self._reward_weights())
        loss = losses.reward_criterion(gen_lp, gen_seq, reward)
        self._apply_updates(loss, lr)
        return {'loss': loss.detach(), 'reward': reward[:, 0].mean()}

    # -- structure losses / PPO ----------------------------------------------
    def struc_fused_step(self, fc, att, labels, masks, am, refs, ref_mask,
                         lr, rng, generator, generator_lm, device_scorer):
        """One structure-loss (or PPO) iteration on the card: (1 - w) XE +
        w structure loss over the sampling pass, scored on
        ``device_scorer`` (the self-CIDEr reward too), w =
        structure_loss_weight.  Returns {'loss', 'lm_loss', 'struc_loss',
        'reward' [B, n]} and PPO's terms."""
        opt = self.opt
        w = float(opt.structure_loss_weight)
        sample_n = int(opt.train_sample_n)
        lm_loss = self._lm_loss(fc, att, labels, masks, am, generator_lm,
                                'mean')
        gen_seq, gen_lp = self.captioner.sample_train(
            fc, att, am, rng, self._train_opt(self.struc_out_ls), generator)
        self_cider_w = float(getattr(opt, 'self_cider_reward_weight', 0))
        with torch.no_grad():
            scores = device_scorer.score_grouped(
                gen_seq, refs, ref_mask, sample_n,
                *self._reward_weights()).float()
            sc_scores = (device_scorer.self_cider_grouped(gen_seq, sample_n)
                         .float() if self_cider_w > 0 else None)
        lp_old = (self._old_logprobs(fc, att, am, gen_seq)
                  if int(getattr(opt, 'use_ppo', 0)) else None)
        struc = self._struc(gen_lp, lp_old, gen_seq, scores, sc_scores,
                            'mean')
        loss = (1 - w) * lm_loss + w * struc['loss']
        self._apply_updates(loss, lr)
        out = {k: v.detach() for k, v in struc.items()}
        out.update(loss=loss.detach(), lm_loss=lm_loss.detach(),
                   struc_loss=struc['loss'].detach())
        return out

    def struc_decode(self, fc, att, am, rng, generator):
        """The structure losses' sampling pass (train mode, not
        differentiated): gen_seq [B*n, L].  Dropout is drawn from a copy
        of ``generator``, which ``struc_grad_step`` then draws again."""
        gen_seq, _ = self.captioner.sample_train(
            fc, att, am, rng, self._train_opt(self.struc_out_ls),
            _copy(generator), return_stats=True)
        return gen_seq

    def struc_grad_step(self, fc, att, labels, masks, am, gen_seq, scores,
                        self_cider_scores, lr, generator, generator_lm,
                        drop_worst_flag=False):
        """(1 - w) XE + w structure loss (or PPO) over ``struc_decode``'s
        samples (loss_wrapper.py:26-53), host scores [B*n] and self-CIDEr
        scores [B].  Returns {'loss', 'lm_loss', 'struc_loss', 'reward'}
        and PPO's terms."""
        opt = self.opt
        w = float(opt.structure_loss_weight)
        reduction = 'none' if drop_worst_flag else 'mean'
        out = {}
        lm_loss = self._lm_loss(fc, att, labels, masks, am, generator_lm,
                                reduction)
        if w > 0:
            lp = self._recompute(fc, att, am, gen_seq, generator,
                                 self.struc_out_ls)
            lp_old = (self._old_logprobs(fc, att, am, gen_seq)
                      if int(getattr(opt, 'use_ppo', 0)) else None)
            struc = self._struc(lp, lp_old, gen_seq, scores,
                                self_cider_scores, reduction)
            struc_loss = struc['loss']
            out.update({k: v.detach() for k, v in struc.items()
                        if k != 'loss'})
        else:
            # structure_loss_weight 0 (pure XE through the structure path)
            # still reports the scores as its reward
            struc_loss = torch.zeros((), device=self.captioner.device)
            out['reward'] = scores.reshape(-1, int(opt.train_sample_n))
        loss = (1 - w) * lm_loss + w * struc_loss
        if drop_worst_flag:
            loss = self._drop_worst(
                loss, float(getattr(opt, 'drop_worst_rate', 0)))
        self._apply_updates(loss, lr)
        out.update(loss=loss.detach(), lm_loss=lm_loss.detach().mean(),
                   struc_loss=struc_loss.detach().mean())
        return out
