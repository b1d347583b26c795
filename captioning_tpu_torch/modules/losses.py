"""Training criterions (port of ``captioning_tpu/modules/losses.py``).

The XE criterions (the masked LM NLL and the label-smoothed KL) and the RL
ones (the SCST policy gradient, the structure-loss family and clip-PPO),
each with the ``reduction='none'`` per-sequence form that drop-worst
reads.  Rewards and scores come in as tensors (``ops/cider_device.py`` or
``utils/rewards.py``) and take no gradient.
"""

from __future__ import annotations

from typing import Dict

import torch


def _gather_tokens(logprobs, seq):
    """[N, L, V] gathered at seq -> [N, L]."""
    return torch.gather(logprobs, 2, seq.long()[..., None])[..., 0]


def _reward_mask(seq):
    """(seq > 0) shifted right with a leading 1: the generated tokens and
    the first EOS (reference losses.py:28-29)."""
    m = (seq > 0).float()
    return torch.cat([torch.ones_like(m[:, :1]), m[:, :-1]], 1)


def language_model_criterion(logprobs, target, mask, reduction='mean'):
    """Masked NLL over [N, L, V] log-probs (reference losses.py:204-224)."""
    if target.dim() == 3:
        target = target.reshape(-1, target.shape[2])
        mask = mask.reshape(-1, mask.shape[2])
    L = logprobs.shape[1]
    target = target[:, :L].long()
    mask = mask[:, :L].float()
    out = -_gather_tokens(logprobs, target) * mask
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


def reward_criterion(sample_logprobs, seq, reward, reduction='mean'):
    """SCST policy gradient (reference losses.py:18-37)."""
    N, L = sample_logprobs.shape[:2]
    mask = _reward_mask(seq)
    out = -_gather_tokens(sample_logprobs, seq) * reward.reshape(N, L) * mask
    if reduction == 'none':
        return out.sum(1) / mask.sum(1).clamp_min(1e-8)
    return out.sum() / mask.sum().clamp_min(1e-8)


def _log_softmax_ce(inp, target):
    """-log_softmax(inp)[target] a row."""
    return -torch.gather(torch.log_softmax(inp, 1), 1, target[:, None])[:, 0]


def structure_loss(input_lp, seq, scores, loss_type: str, seq_per_img: int,
                   entropy_reward_weight: float = 0.0,
                   self_cider_scores=None, self_cider_weight: float = 0.0,
                   reduction='mean') -> Dict[str, torch.Tensor]:
    """The structured-prediction loss family (reference losses.py:40-202):
    seqnll, risk, max_margin, multi_margin, softmax_margin,
    real_softmax_margin, new_self_critical and best_of_n.

    input_lp: [N, L, V] log-probs (logits for the margin losses); scores:
    [N] sequence scores; self_cider_scores: [B] or None."""
    out = {}
    mask = _reward_mask(seq)
    scores = scores.reshape(-1, seq_per_img)
    out['reward'] = scores
    if entropy_reward_weight > 0:
        with torch.no_grad():
            entropy = -(torch.softmax(input_lp, 2)
                        * torch.log_softmax(input_lp, 2)).sum(2)
            entropy = (entropy * mask).sum(1) / mask.sum(1)
        scores = scores + entropy_reward_weight * entropy.reshape(
            -1, seq_per_img)

    costs = -scores
    if loss_type in ('risk', 'softmax_margin'):
        costs = costs - costs.min(1, keepdim=True).values
        costs = costs / costs.max(1, keepdim=True).values.clamp_min(1e-8)

    tok_lp = _gather_tokens(input_lp, seq)

    def seq_mean(x):
        return ((x * mask).sum(1) / mask.sum(1).clamp_min(1e-8)
                ).reshape(-1, seq_per_img)

    def token_mean(o):
        if reduction == 'none':
            return o.sum(1) / mask.sum(1).clamp_min(1e-8)
        return o.sum() / mask.sum().clamp_min(1e-8)

    if loss_type == 'seqnll':
        ce = _log_softmax_ce(seq_mean(tok_lp), torch.argmin(costs, 1))
        output = ce.mean() if reduction == 'mean' else ce
    elif loss_type == 'risk':
        inp = (tok_lp * mask).sum(1).reshape(-1, seq_per_img)
        output = (torch.softmax(torch.exp(inp), 1) * costs).sum(1).mean()
    elif loss_type in ('max_margin', 'multi_margin'):
        inp = seq_mean(tok_lp)
        star = torch.argmin(costs, 1, keepdim=True)
        viol = torch.relu(costs - torch.gather(costs, 1, star)
                          - torch.gather(inp, 1, star) + inp)
        if loss_type == 'max_margin':
            output = (viol.max(1).values / 2).mean()
        else:
            output = viol.mean()
    elif loss_type in ('softmax_margin', 'real_softmax_margin'):
        ce = _log_softmax_ce(seq_mean(tok_lp) + costs,
                             torch.argmin(costs, 1))
        output = ce.mean() if reduction == 'mean' else ce
    elif loss_type == 'new_self_critical':
        # leave-one-out mean baseline (reference losses.py:168-187)
        baseline = (scores.sum(1, keepdim=True) - scores) / (
            scores.shape[1] - 1)
        adv = scores - baseline
        if self_cider_scores is not None and self_cider_weight > 0:
            adv = adv + self_cider_weight * self_cider_scores.reshape(-1, 1)
        output = token_mean(-tok_lp * mask * adv.reshape(-1, 1))
    elif loss_type == 'best_of_n':
        best = (scores == scores.max(1, keepdim=True).values).float()
        output = token_mean(-tok_lp * mask * best.reshape(-1, 1))
    else:
        raise ValueError('unknown structure_loss_type %s' % loss_type)

    out['loss'] = output
    return out


def masked_mean(tensor, mask, dim=None):
    if dim is None:
        return (tensor * mask).sum() / mask.sum().clamp_min(1e-8)
    return (tensor * mask).sum(dim) / mask.sum(dim).clamp_min(1e-8)


def ppo_loss(new_logprobs, old_logprobs, seq, scores, seq_per_img: int,
             cliprange: float = 0.2, kl_coef: float = 0.02,
             reduction='mean') -> Dict[str, torch.Tensor]:
    """clip-PPO plus the KL to the frozen old policy (reference
    losses.py:267-357).  new / old_logprobs: [N, L, V] log-softmax tables
    over the sampled seq; the old one takes no gradient."""
    out = {}
    mask = _reward_mask(seq)
    scores = scores.reshape(-1, seq_per_img)
    out['reward'] = scores
    baseline = (scores.sum(1, keepdim=True) - scores) / (scores.shape[1] - 1)
    adv = (scores - baseline).reshape(-1, 1)

    old_logprobs = old_logprobs.detach()
    ratio = torch.exp(_gather_tokens(new_logprobs, seq)
                      - _gather_tokens(old_logprobs, seq))
    pg_loss = torch.maximum(-adv * ratio, -adv * torch.clamp(
        ratio, 1.0 - cliprange, 1.0 + cliprange))

    # KL(old || new) summed over the vocab (F.kl_div(log_target=True))
    kl = (torch.exp(old_logprobs) * (old_logprobs - new_logprobs)).sum(-1)
    out['pg_loss'] = masked_mean(pg_loss, mask)
    out['kl_loss'] = masked_mean(kl, mask)
    out['clipfrac'] = masked_mean(
        ((ratio - 1.0).abs() > cliprange).float(), mask)
    if reduction == 'none':
        out['loss'] = masked_mean(pg_loss + kl_coef * kl, mask, dim=1)
    else:
        out['loss'] = out['pg_loss'] + kl_coef * out['kl_loss']
    return out
