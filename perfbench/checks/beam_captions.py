"""``correct`` of an eval cell: the captions ``eval_split`` returned in
the window, judged one by one against the plain float32 reference
(``reference/<config>.py``, ``reference/decode.py``) on the same weights
and features.

For each sampled image (drawn from the seed among the window's answers)
the reference scores the served caption by teacher forcing: the log-prob
of each of its tokens, UNK suppressed, and the entropy of each
distribution that chose one, summed up to the end token, over the
caption's length + 1, as ``eval_split`` reports them.  The numbers, each
the widest over the sample but the mean:

* ``ppl_gap``: the served perplexity against the reference's of the same
  tokens (nats a token);
* ``ent_gap``: the same for the served entropy;
* ``rank_gap``: how far a served token's reference log-prob lies below
  the beam-size-th best of its position, given the served prefix (0
  where it is among the beam-size best: a beam keeps no token below
  them), nats;
* ``beam_gap_mean``: how far a served caption's reference score (its
  log-prob sum) lies below the reference's own beam's best caption of
  the image, the mean over the sample, nats.

A token altered where it is produced, or an image given another's
caption, moves the reference's sums away from the served ones.  A
selection that keeps the wrong candidates (a top-k past its k best, a
beam cut to one) serves captions that score below the reference beam's:
on most images, so the mean moves, and where a token below the k-th
best is served, ``rank_gap``.  The widest of those caption gaps
(``beam_gap``, printed beside) is not compared: in bfloat16 the beam
leaves the float32 path at near ties, and on a few images of a sound run
it scores nats below (PERF.md).

The control (``control``) is the reference in float8 e4m3 put in the
program's place: its own beam search and its own sums, judged the same
way.  ``FAULTS`` plants a fault in the float32 reference put in the
program's place instead: ``skip_best``, a selection that keeps each
row's ranks 2 to k + 1; ``beam_one``, a beam cut to one (greedy).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import common, decode

BLOCK = 64          # images a block of the reference
FAULTS = ('skip_best', 'beam_one')


def _run(h, W, sample, own, fault=None):
    """The numbers of the sample; ``own``: the model under ``W``
    decodes and scores its own captions (the float8 control, or with
    ``fault`` the float32 reference with the fault planted) instead of
    judging the served ones."""
    opt = h.options
    bdash = int(h.traffic['eval_kwargs']['beam_size'])
    L, V = opt['max_length'], opt['vocab_size']
    ref = h.cell.reference().Model(common.Weights(W), opt)
    low = h.cell.reference().Model(common.Weights(W, low=fault is None),
                                   opt) if own else None
    gaps = {'ppl_gap': 0.0, 'ent_gap': 0.0, 'rank_gap': 0.0,
            'beam_gap': -np.inf}
    beam_gaps = []
    k = len(sample['images'])
    with torch.no_grad():
        for a in range(0, k, BLOCK):
            b = min(a + BLOCK, k)
            dev = {x: torch.from_numpy(np.ascontiguousarray(
                sample[x][a:b])).to(h.device) for x in ('fc', 'att', 'am')}
            rows = torch.arange(b - a, device=h.device)
            feats = ref.prepare(dev['fc'], dev['att'], dev['am'])
            if own:
                lfeats = low.prepare(dev['fc'], dev['att'], dev['am'])
                tokens, _ = decode.beam_search(
                    low, lfeats, b - a, 1 if fault == 'beam_one' else bdash,
                    L, V, fault == 'skip_best')
                lp, ent, den, _ = decode.caption_sums(low, lfeats, rows,
                                                      tokens, V, bdash)
                ppl_s, ent_s = -lp / den, ent / den
            else:
                tokens = torch.from_numpy(sample['tokens'][a:b]).to(h.device)
                ppl_s = torch.from_numpy(sample['perplexity'][a:b]).to(
                    h.device).float()
                ent_s = torch.from_numpy(sample['entropy'][a:b]).to(
                    h.device).float()
            lp, ent, den, below = decode.caption_sums(ref, feats, rows,
                                                      tokens, V, bdash)
            gaps['ppl_gap'] = max(gaps['ppl_gap'], float(
                (ppl_s + lp / den).abs().max()))
            gaps['ent_gap'] = max(gaps['ent_gap'], float(
                (ent_s - ent / den).abs().max()))
            gaps['rank_gap'] = max(gaps['rank_gap'], float(below.max()))
            _, best = decode.beam_search(ref, feats, b - a, bdash, L, V)
            beam_gaps.append((best - lp).cpu().numpy())
    beam_gaps = np.concatenate(beam_gaps)
    gaps['beam_gap'] = float(beam_gaps.max())
    gaps['beam_gap_mean'] = float(beam_gaps.mean())
    return gaps


def judge(h, W, sample):
    """The numbers of the served sample."""
    common.no_tf32()
    return _run(h, W, sample, own=False)


def control(h, W, sample, fault=None):
    """The numbers of the float8 control on the sample's images, or with
    ``fault`` (one of ``FAULTS``) those of the float32 reference in the
    program's place with that fault planted."""
    if fault not in (None,) + FAULTS:
        raise ValueError('no fault %r: %s' % (fault, ', '.join(FAULTS)))
    common.no_tf32()
    return _run(h, W, sample, own=True, fault=fault)
