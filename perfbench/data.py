"""The inputs a cell feeds the program, made from the seed: the vocab,
bottom-up region features, reference captions, and the loader that
``eval_split`` walks.

Features are made on the device (one ``torch.randn``) and copied to host
memory as float32 numpy arrays, as a feature loader hands them over:
``eval_split`` copies each batch to the card from pageable memory, the
copy a user's eval pays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import seeds


def vocab(V: int):
    """A COCO-sized vocab, one distinct word an index, UNK last (as
    upstream ``prepro_labels`` writes it): a caption's words give back its
    tokens."""
    out = {str(i): 'w%d' % i for i in range(1, V + 1)}
    out[str(V)] = 'UNK'
    return out


def tokens(captions, V: int, L: int) -> np.ndarray:
    """The tokens [N, L] of caption strings over ``vocab(V)``, 0 after the
    end."""
    out = np.zeros((len(captions), L), np.int64)
    for i, c in enumerate(captions):
        words = c.split()
        out[i, :len(words)] = [V if w == 'UNK' else int(w[1:])
                               for w in words]
    return out


def features(n: int, regions: int, feat: int, use_fc: bool, seed: int,
             device):
    """(fc [n, feat] or [n, 0], att [n, regions, feat], att_masks [n,
    regions]) float32 numpy arrays: att a standard normal drawn on
    ``device`` from the seed, fc the regions' mean (the bottom-up fc
    features), every region valid."""
    g = torch.Generator(device).manual_seed(seeds.derive(seed, 'features'))
    att = torch.randn(n, regions, feat, generator=g, device=device)
    fc = att.mean(1) if use_fc else att.new_zeros(n, 0)
    return (fc.cpu().numpy(), att.cpu().numpy(),
            np.ones((n, regions), np.float32))


class SplitLoader:
    """The loader ``eval_split`` reads: one split of ``n`` images in
    batches of ``batch`` (the last one shorter), with real ``bounds``
    (``it_max`` the split's size, ``wrapped`` at its end) and no labels.
    ``marks`` records the time of every ``get_batch`` call while
    ``recording``."""

    def __init__(self, fc, att, am, vocab_, batch: int):
        self.fc, self.att, self.am = fc, att, am
        self.vocab = vocab_
        self.batch = batch
        self.n = att.shape[0]
        self.pos = 0
        self.recording = False
        self.marks = []

    def reset_iterator(self, split):
        self.pos = 0

    def get_vocab(self):
        return self.vocab

    def get_batch(self, split):
        if self.recording:
            self.marks.append(time.perf_counter())
        a, b = self.pos, min(self.pos + self.batch, self.n)
        self.pos = 0 if b >= self.n else b
        return {'fc_feats': self.fc[a:b], 'att_feats': self.att[a:b],
                'att_masks': self.am[a:b], 'labels': None, 'masks': None,
                'infos': [{'id': i, 'file_path': ''} for i in range(a, b)],
                'bounds': {'it_pos_now': self.pos, 'it_max': self.n,
                           'wrapped': b >= self.n}}
