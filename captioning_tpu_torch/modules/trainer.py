"""The XE train step: teacher-forced pass, criterion, backward, clip and
the optimizer step with the injected learning rate.

Port of ``captioning_tpu/modules/trainer.py:29-111``.  The JAX trainer is
functional (variables and optax state in, updated copies out, one jitted
step); here the captioner's parameters, its BatchNorm statistics and the
``torch.optim`` state are updated in place.  ``opt_state_jax`` /
``load_opt_state_jax`` carry the optimizer state in the JAX package's
``optimizer.npz`` layout.  The SCST, structure and PPO steps come with
ROADMAP.md A5.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils import optimizers as optim_utils
from . import losses

_A5 = ('%s is not ported yet: SCST, structure and PPO training come with '
       'ROADMAP.md A5')


class Trainer:
    def __init__(self, captioner, opt):
        self.captioner = captioner.trainable()
        self.opt = opt
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

    # -- RL: ROADMAP.md A5 ----------------------------------------------------
    def sc_decode(self, *args, **kwargs):
        raise NotImplementedError(_A5 % 'sc_decode')

    def sc_grad_step(self, *args, **kwargs):
        raise NotImplementedError(_A5 % 'sc_grad_step')

    def sc_fused_step(self, *args, **kwargs):
        raise NotImplementedError(_A5 % 'sc_fused_step')

    def struc_decode(self, *args, **kwargs):
        raise NotImplementedError(_A5 % 'struc_decode')

    def struc_grad_step(self, *args, **kwargs):
        raise NotImplementedError(_A5 % 'struc_grad_step')

    def struc_fused_step(self, *args, **kwargs):
        raise NotImplementedError(_A5 % 'struc_fused_step')
