"""Training criterions (port of ``captioning_tpu/modules/losses.py``).

The XE criterions: the masked LM NLL and the label-smoothed KL, each with
the ``reduction='none'`` per-sequence form that drop-worst reads.  The RL
criterions come with SCST (ROADMAP.md, A5).
"""

from __future__ import annotations

import torch


def language_model_criterion(logprobs, target, mask, reduction='mean'):
    """Masked NLL over [N, L, V] log-probs (reference losses.py:204-224)."""
    if target.dim() == 3:
        target = target.reshape(-1, target.shape[2])
        mask = mask.reshape(-1, mask.shape[2])
    L = logprobs.shape[1]
    target = target[:, :L].long()
    mask = mask[:, :L].float()
    out = -torch.gather(logprobs, 2, target[..., None])[..., 0] * mask
    if reduction == 'none':
        return out.sum(1) / mask.sum(1).clamp_min(1e-8)
    return out.sum() / mask.sum().clamp_min(1e-8)


def label_smoothing_criterion(logprobs, target, mask, smoothing: float,
                              reduction='mean'):
    """KLDiv against the smoothed one-hot (reference losses.py:227-265):
    ``1 - smoothing`` on the target, ``smoothing / (V - 1)`` elsewhere."""
    if target.dim() == 3:
        target = target.reshape(-1, target.shape[2])
        mask = mask.reshape(-1, mask.shape[2])
    N, L, V = logprobs.shape
    target = target[:, :L].reshape(-1).long()
    mask = mask[:, :L].float().reshape(-1)
    x = logprobs.reshape(-1, V)
    true_dist = torch.full_like(x, smoothing / (V - 1))
    true_dist.scatter_(1, target[:, None], 1.0 - smoothing)
    # KLDiv(log_input, target) = target * (log(target) - input); 0 log 0 = 0
    log_td = torch.where(true_dist > 0, true_dist.clamp_min(1e-38).log(),
                         torch.zeros_like(true_dist))
    kl = (true_dist * (log_td - x)).sum(-1) * mask
    if reduction == 'none':
        return (kl.reshape(N, L).sum(1)
                / mask.reshape(N, L).sum(1).clamp_min(1e-8))
    return kl.sum() / mask.sum().clamp_min(1e-8)
