"""Training criterions (port of ``captioning_tpu/modules/losses.py``).

Only the masked LM criterion exists so far: ``eval_split`` takes the val
loss with it.  The rest comes with XE training (ROADMAP.md).
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
