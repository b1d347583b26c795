"""Inference-time model ensemble.

Port of ``captioning_tpu/models/ensemble.py``: each member's per-step
probabilities are weighted-averaged in probability space, then logged.
The ensemble's state is a dict of the member states (``m0`` .. ``mN``);
a beam reorder goes to each member's own ``beam_reorder`` (the
transformer's ancestry, its caches unmoved) or to the engine's row
gather.  The members may differ in architecture (e.g. UpDown and the
transformer): their steps run one after another.

The ensemble has no ``step_topk``: its vocab epilogue is the engine's
plain-step route, as in the JAX package.  Its entry points are the ones
``utils.eval_utils.eval_split`` / ``eval_split_n`` call on a
``Captioner`` (``models.api.DecodeEntries``), the graph decodes (the
counterparts of the JAX ``sample_jit`` / ``sample_beam_jit``) included.
Where the JAX ``eval_split`` decodes an ensemble's greedy through the
per-step tables (the JAX ensemble has no ``sample_stats_jit``), the
port's takes the carried-stats route: the same tokens, the sums within
float rounding.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..engine import decoding
from ..engine.decoding import DecodeModel
from .api import DecodeEntries


class EnsembleCaptioner(DecodeEntries):
    """A ``Captioner``-like facade over loaded port ``Captioner``s on one
    device.  ``weights`` (default equal) are normalised to sum 1 in
    float32.  ``cfg``, ``vocab``, ``unk_idx`` and ``bad_endings_ix`` are
    member 0's.  The graph decodes read the members' modules as they are
    when captured: reload a member's weights and make a new ensemble."""

    def __init__(self, captioners: List, weights: Optional[Sequence[float]]
                 = None):
        devices = {c.device for c in captioners}
        if len(devices) != 1:
            raise ValueError('ensemble members on more than one device: %s'
                             % sorted(str(d) for d in devices))
        self.members = list(captioners)
        self.device = captioners[0].device
        self.cfg = captioners[0].cfg
        self.vocab = captioners[0].vocab
        self.bad_endings_ix = captioners[0].bad_endings_ix
        self.unk_idx = captioners[0].unk_idx
        w = torch.tensor(weights if weights is not None
                         else [1.0] * len(captioners), dtype=torch.float32)
        self.weights = w / w.sum()
        # (kind, options, shapes, dtypes) -> GraphDecode, as Captioner's
        self._graph_cache = {}
        self.graph_recorder = None

    def _graph_dtype(self):
        return tuple(c.cfg.dtype for c in self.members)

    def bind(self) -> DecodeModel:
        dms = [c.bind() for c in self.members]
        # the float32 weights as host scalars: exact, and baked into a graph
        weights = self.weights.tolist()

        def prepare(fc, att, att_masks, rng):
            return {'m%d' % i: dm.prepare(fc, att, att_masks, rng)
                    for i, dm in enumerate(dms)}

        def init_state(batch, beam=False):
            return {'m%d' % i: dm.init_state(batch, beam=beam)
                    for i, dm in enumerate(dms)}

        def step(it, feats, state, rng, logsoftmax=True, uniform_t=False,
                 beam_width=0):
            probs = None
            new_state = {}
            for i, dm in enumerate(dms):
                # only members whose caches were beam_init'ed attend
                # through an ancestry table
                bw = beam_width if dm.beam_init is not None else 0
                lp, st = dm.step(it, feats['m%d' % i], state['m%d' % i],
                                 rng, True, uniform_t=uniform_t,
                                 beam_width=bw)
                p = lp.exp() * weights[i]
                probs = p if probs is None else probs + p
                new_state['m%d' % i] = st
            return torch.log(probs.clamp_min(1e-38)), new_state

        def beam_init(state, bdash):
            return {'m%d' % i: (dm.beam_init(state['m%d' % i], bdash)
                                if dm.beam_init is not None
                                else state['m%d' % i])
                    for i, dm in enumerate(dms)}

        def beam_reorder(state, flat_idx):
            return {'m%d' % i: (dm.beam_reorder(state['m%d' % i], flat_idx)
                                if dm.beam_reorder is not None
                                else decoding.reorder_state(state['m%d' % i],
                                                            flat_idx))
                    for i, dm in enumerate(dms)}

        cfg = self.cfg
        return DecodeModel(
            prepare=prepare, init_state=init_state, step=step,
            seq_length=cfg.seq_length, vocab_plus=cfg.vocab_size + 1,
            bos_idx=cfg.bos_idx, eos_idx=cfg.eos_idx, pad_idx=cfg.pad_idx,
            unk_idx=self.unk_idx, bad_endings_ix=self.bad_endings_ix,
            beam_init=beam_init, beam_reorder=beam_reorder,
            # block-shared beam feats only when every member takes them:
            # each member's step sees its own feats in one layout
            shared_beam_feats=all(dm.shared_beam_feats for dm in dms))

    def forward_tf(self, fc_feats, att_feats, seq, att_masks,
                   train: bool = False):
        """Teacher-forced log-probs [N, T, V+1] of the member mixture:
        the members' probabilities averaged by the weights, then logged.
        Eval only, under inference mode."""
        if train:
            raise ValueError('the ensemble is eval-only: forward_tf takes '
                             'no train mode')
        probs = None
        with torch.inference_mode():
            for c, w in zip(self.members, self.weights.tolist()):
                p = c.forward_tf(fc_feats, att_feats, seq, att_masks).exp() \
                    * w
                probs = p if probs is None else probs + p
            return torch.log(probs.clamp_min(1e-38))
