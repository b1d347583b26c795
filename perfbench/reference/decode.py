"""Beam search and the scoring of given captions over a plain reference
model (``transformer.Transformer`` or ``updown.UpDown``: ``prepare``,
``init_state``, ``step``, ``reorder``, ``teacher_forced``).

The beam search is upstream's single-group beam (ImageCaptioning.pytorch
``beam_search`` with one group and no constraints), as the captioners'
eval decodes run it: the bos step's log-softmax, UNK suppressed, gives
the first ``bdash`` beams; each later step extends every beam by every
token, the log-softmax (UNK suppressed) added to the beam's sum, and
keeps the ``bdash`` best of the ``bdash * (V + 1)`` candidates, ties to
the lowest flat index.  A beam whose token is the end (0), or that
reaches ``L`` tokens, enters the pool of finished captions with its sum
as score and stays among the beams 1000 lower.  The pool keeps the
``bdash`` best scores, an entry already in it before a new one of the
same score.  The answer is the pool's best.

``skip_best`` plants a selection fault: each row's best token is taken out
before the selection, as a per-row top-k that kept ranks 2 to k + 1
would.
"""

from __future__ import annotations

import torch

from .common import entropy, unk_adjust

NEG = -1e30


def _top(x, k):
    """(values, indices) of the k largest of each row, ties to the lowest
    index."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _drop_best(lsm, skip: bool):
    """``lsm`` with each row's best entry at NEG where ``skip``."""
    if not skip:
        return lsm
    return lsm.scatter(-1, lsm.argmax(-1, keepdim=True), NEG)


def beam_search(model, feats, K: int, bdash: int, L: int, unk_idx: int,
                skip_best: bool = False):
    """The best finished caption of each of the K images of ``feats``:
    (tokens [K, L], 0 after the end; its score [K])."""
    dev = next(iter(x for x in feats if torch.is_tensor(x))).device
    rows = torch.arange(K, device=dev)
    prefix = torch.zeros(K, 1, dtype=torch.long, device=dev)
    lsm, state = model.step(prefix, feats, rows, model.init_state(K, dev))
    ys, tok = _top(_drop_best(unk_adjust(lsm, unk_idx), skip_best), bdash)
    beam_ix = torch.zeros(K, bdash, dtype=torch.long, device=dev)
    seq = torch.zeros(K, bdash, L, dtype=torch.long, device=dev)
    pool_p = torch.full((K, bdash), NEG, device=dev)
    pool_seq = torch.zeros_like(seq)
    rows = rows.repeat_interleave(bdash)
    if state is not None:
        state = model.reorder(state, rows)
    base = torch.arange(K, device=dev)[:, None] * bdash
    for t in range(L):
        if t:
            prefix = torch.cat([torch.zeros(K * bdash, 1, dtype=torch.long,
                                            device=dev),
                                seq[:, :, :t].reshape(K * bdash, t)], 1)
            lsm, state = model.step(prefix, feats, rows, state)
            cand = (_drop_best(unk_adjust(lsm, unk_idx), skip_best).view(
                K, bdash, -1) + sums[:, :, None])
            V1 = cand.shape[2]
            ys, ix = _top(cand.view(K, bdash * V1), bdash)
            beam_ix, tok = ix // V1, ix % V1
            if state is not None:
                state = model.reorder(state, (base + beam_ix).view(-1))
        seq = torch.gather(seq, 1, beam_ix[..., None].expand(-1, -1, L))
        seq[:, :, t] = tok
        ended = (tok == 0) | (t == L - 1)
        p, i = _top(torch.cat([pool_p, torch.where(ended, ys, NEG)], 1),
                    bdash)
        pool_p = p
        pool_seq = torch.gather(torch.cat([pool_seq, seq], 1), 1,
                                i[..., None].expand(-1, -1, L))
        sums = ys - 1000.0 * ended
    return pool_seq[:, 0], pool_p[:, 0]


def caption_sums(model, feats, rows, tokens, unk_idx: int, k: int):
    """The sums a decode carries for given captions tokens [R, L] (0 after
    the end) of images ``rows``: (the log-prob of each token, UNK
    suppressed, summed up to and including the end token or the L-th
    token [R]; the entropies of the distributions that chose them, summed
    [R]; the caption's length + 1 [R], the denominator of the reported
    perplexity and entropy; the widest gap by which one of those tokens'
    log-prob lies below the k-th best of its position, 0 where it is
    among the k best [R]: a beam of k keeps no token below it)."""
    R, L = tokens.shape
    inp = torch.cat([torch.zeros(R, 1, dtype=torch.long,
                                 device=tokens.device), tokens[:, :-1]], 1)
    lsm = unk_adjust(model.teacher_forced(feats, rows, inp), unk_idx)
    lp = torch.gather(lsm, 2, tokens[..., None])[..., 0]
    ended_before = torch.cumsum((tokens == 0).long(), 1) - (tokens == 0).long()
    keep = (ended_before == 0).float()
    denom = (tokens > 0).sum(1).float() + 1.0
    below = (lsm.topk(k, -1).values[..., -1] - lp).clamp_min(0.0)
    return ((lp * keep).sum(1), (entropy(lsm) * keep).sum(1), denom,
            (below * keep).amax(1))

