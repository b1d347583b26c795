"""Meshed-Memory Transformer captioner (Cornia et al., arXiv:1912.08226).

Port of ``captioning_tpu/models/m2.py``:

* a memory-augmented encoder: each self-attention appends
  ``M2_MEMORY_SLOTS`` learned slots to its keys and values (keys scaled by
  sqrt(d_model), values by sqrt(slots), in float32 from the masters, then
  cast to the keys' dtype), every layer's output kept as one encoder
  *level*: ``prepare_feature`` returns ``levels`` [B, E, M, D];
* a meshed decoder: each layer's cross-attention (one block shared by the
  levels) attends every level, each output gated by
  ``sigmoid(dec_gates_<i>_<e>([x; att]))`` and the sum divided by
  sqrt(N_enc) rounded in the compute dtype;
* post-LN blocks (``M2LayerNorm``: the biased variance, eps 1e-5) with a
  relu feed-forward; the token embedding scaled by sqrt(d_model) plus the
  sinusoidal table of ``max(L + 4, 64)`` rows.

The decode step is ``transformer.CachedDecoder``'s (B1 for the uniform
eval step's self-attention); the cross-attention of a step is the folded
form (``lazy_cross``) over each level, the query folded once a layer (the
same ``q W_k`` serves every level).  ``forward_tf`` projects the cross
K / V of each (layer, level) once an image and attends them grouped over
its ``seq_per_img`` rows.

Module and parameter names follow the JAX tree (``enc_self_0.mem_k``,
``dec_gates_1_0``, ``vis_ln``), so the weight bridge maps keys one to one.
Train mode is the generator ``gen``.  Dropout at the JAX sites, all at
``dropout``: the visual embed, the attention probabilities, each ``wo``
output, each level's cross-attention output and the feed-forward's inner
and outer activations.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.beam_attend import sqrt_in
from .bert_cap import BertAttnBlock, BertLayerNorm
from .config import ModelConfig
from .layers import (MaskedBatchNorm, compute_param, dropout, init_dense,
                     install_compute_copies, linear)
from .transformer import (CachedDecoder, _attend, _Lin, _merge_heads,
                          _split_heads, fold_query, lazy_cross, pos_rows,
                          sinusoid_table, tf_masks)

M2_MEMORY_SLOTS = 40


class M2LayerNorm(BertLayerNorm):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__(c, eps)


class M2Attn(BertAttnBlock):
    """An attention block with M2's LayerNorm and, in the encoder,
    ``memory`` learned key / value slots."""

    norm = M2LayerNorm

    def __init__(self, D: int, memory: int = 0):
        super().__init__(D)
        self.memory = memory
        if memory:
            self.mem_k = nn.Parameter(torch.zeros(memory, D))
            self.mem_v = nn.Parameter(torch.zeros(memory, D))

    def self_attend(self, x, mask, h: int, p: float, gen):
        """The encoder's self-attention over x and the memory slots; mask
        [B, 1, 1, M] or None."""
        B, _, D = x.shape
        k, v = linear(x, self.wk), linear(x, self.wv)
        mk = (self.mem_k * math.sqrt(D)).to(k.dtype)
        mv = (self.mem_v * math.sqrt(self.memory)).to(v.dtype)
        k = torch.cat([k, mk[None].expand(B, -1, -1)], 1)
        v = torch.cat([v, mv[None].expand(B, -1, -1)], 1)
        if mask is not None:
            mask = torch.cat([mask, mask.new_ones(
                mask.shape[:-1] + (self.memory,))], -1)
        return self.attend(x, _split_heads(k, h), _split_heads(v, h), mask,
                           h, p, gen)


class M2Captioner(CachedDecoder):
    """M2 transformer exposing the engine step protocol."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        D, F_ = cfg.d_model, cfg.d_ff
        self.att_bn_in = MaskedBatchNorm(cfg.att_feat_size) \
            if cfg.use_bn else None
        self.vis_embed = nn.Linear(cfg.att_feat_size, D)
        self.vis_ln = M2LayerNorm(D)
        for i in range(cfg.N_enc):
            self.add_module('enc_self_%d' % i, M2Attn(D, M2_MEMORY_SLOTS))
            self.add_module('enc_ff1_%d' % i, nn.Linear(D, F_))
            self.add_module('enc_ff2_%d' % i, nn.Linear(F_, D))
            self.add_module('enc_ffln_%d' % i, M2LayerNorm(D))
        for i in range(cfg.N_dec):
            self.add_module('dec_self_%d' % i, M2Attn(D))
            self.add_module('dec_cross_%d' % i, M2Attn(D))
            for e in range(cfg.N_enc):
                self.add_module('dec_gates_%d_%d' % (i, e),
                                nn.Linear(2 * D, D))
            self.add_module('dec_ff1_%d' % i, nn.Linear(D, F_))
            self.add_module('dec_ff2_%d' % i, nn.Linear(F_, D))
            self.add_module('dec_ffln_%d' % i, M2LayerNorm(D))
        V1 = cfg.vocab_size + 1
        self.word_embed = nn.Parameter(torch.zeros(V1, D))
        self.generator = _Lin(D, V1)
        self.register_buffer('pe', torch.from_numpy(
            sinusoid_table(max(cfg.seq_length + 4, 64), D)),
            persistent=False)

    def _blk(self, name: str, *idx):
        return getattr(self, '_'.join([name] + [str(i) for i in idx]))

    # -- parameters ----------------------------------------------------------
    def init_weights(self, generator: torch.Generator):
        """The JAX module's init, drawn from ``generator``: Dense
        U(+-1/sqrt(fan_in)), the generator's kernel xavier-uniform, the word
        embedding N(0, 0.02), the memory slots N(0, 1/D) for keys and
        N(0, 1/slots) for values."""
        D = self.cfg.d_model
        for m in self.modules():
            if isinstance(m, _Lin):
                m.init_weights(generator)
            elif isinstance(m, nn.Linear):
                init_dense(m, generator)
        with torch.no_grad():
            self.word_embed.normal_(0.0, 0.02, generator=generator)
            for i in range(self.cfg.N_enc):
                blk = self._blk('enc_self', i)
                blk.mem_k.normal_(0.0, 1.0 / np.sqrt(D), generator=generator)
                blk.mem_v.normal_(0.0, 1.0 / np.sqrt(blk.memory),
                                  generator=generator)
        return self

    def install_compute_copies(self):
        return install_compute_copies(self, self.cfg.dtype, nn.Linear,
                                      extra=('word_embed',))

    def _embed(self, ids, pe):
        dt = self.cfg.dtype
        x = (compute_param(self, 'word_embed')[ids].to(dt)
             * sqrt_in(self.cfg.d_model, dt))
        return x + pe.to(dt)

    def _ffn(self, part: str, i: int, x, gen):
        p = self.cfg.dropout
        y = dropout(torch.relu(linear(x, self._blk(part + '_ff1', i))), p,
                    gen)
        y = dropout(linear(y, self._blk(part + '_ff2', i)), p, gen)
        return self._blk(part + '_ffln', i)(x + y)

    # -- encoder -------------------------------------------------------------
    def encode(self, att_feats, att_masks, gen=None):
        """Every encoder layer's output, [B, E, M, D]."""
        cfg = self.cfg
        x = att_feats
        if self.att_bn_in is not None:
            x = self.att_bn_in(x, att_masks, gen is not None)
        x = torch.relu(linear(x, self.vis_embed))
        x = self.vis_ln(dropout(x, cfg.dropout, gen))
        mask = None if att_masks is None else att_masks[:, None, None, :]
        levels = []
        for i in range(cfg.N_enc):
            x = self._blk('enc_self', i).self_attend(
                x, mask, cfg.num_att_heads, cfg.dropout, gen)
            x = self._ffn('enc', i, x, gen)
            levels.append(x)
        return torch.stack(levels, 1)

    def prepare_feature(self, fc_feats, att_feats, att_masks, gen=None):
        # decode steps attend the raw levels with the cross K/V projections
        # folded around the attention (lazy_cross)
        return {'levels': self.encode(att_feats, att_masks, gen),
                'att_masks': att_masks}

    # -- decoder -------------------------------------------------------------
    def _mesh(self, i, x, cross, gen):
        """The meshed sum of decoder layer i: each level's cross-attention
        output ``cross(e)`` through dropout and its gate, summed, divided
        by sqrt(N_enc) in the compute dtype; then the cross block's
        post-LN residual and the feed-forward."""
        p, E = self.cfg.dropout, self.cfg.N_enc
        total = None
        for e in range(E):
            att = dropout(cross(e), p, gen)
            gate = torch.sigmoid(linear(torch.cat([x, att], -1),
                                        self._blk('dec_gates', i, e)))
            total = gate * att if total is None else total + gate * att
        total = total / sqrt_in(E, total.dtype)
        x = self._blk('dec_cross', i).ln(x + total)
        return self._ffn('dec', i, x, gen)

    def _embed_step(self, it, t, gen):
        return self._embed(it, pos_rows(self.pe, t))

    def _layer(self, i, x, attend, feats, gen):
        """Decoder layer i of a step: the self-attention through
        ``attend``, the folded cross-attention over each level, the meshed
        sum."""
        h, p = self.cfg.num_att_heads, self.cfg.dropout
        blk = self._blk('dec_self', i)
        x = blk.residual(x, attend(linear(x, blk.wq), linear(x, blk.wk),
                                   linear(x, blk.wv)), p, gen)
        cblk = self._blk('dec_cross', i)
        levels, am = feats['levels'], feats['att_masks']
        qt = fold_query(x, cblk.wq, cblk.wk, h, levels.dtype)
        return self._mesh(i, x, lambda e: lazy_cross(
            qt, levels[:, e], am, cblk.wv, cblk.wo, h, p, gen), gen)

    # -- teacher forcing ---------------------------------------------------------
    def forward_tf(self, fc_feats, att_feats, seq, att_masks, gen=None,
                   ss_prob: float = 0.0):
        """Teacher-forced log-probs [N, T, V+1] over input tokens ``seq``,
        in train mode given ``gen``: the cross K / V of each (layer, level)
        projected once an image, the ``seq_per_img`` rows attending them
        grouped.  ``ss_prob`` is unused, as in the JAX module."""
        cfg = self.cfg
        h, p = cfg.num_att_heads, cfg.dropout
        if seq.dim() == 3:
            seq = seq.reshape(-1, seq.shape[2])
        levels = self.encode(att_feats, att_masks, gen)
        nb = levels.shape[0]
        s = seq.shape[0] // nb
        T = seq.shape[1]
        tgt_mask = tf_masks(seq, cfg)
        src_mask = (None if att_masks is None
                    else att_masks[:, None, None, None, :])
        x = self._embed(seq, self.pe[:T])
        for i in range(cfg.N_dec):
            blk = self._blk('dec_self', i)
            k = _split_heads(linear(x, blk.wk), h)
            v = _split_heads(linear(x, blk.wv), h)
            x = blk.attend(x, k, v, tgt_mask, h, p, gen)
            cblk = self._blk('dec_cross', i)
            # [nb, E, h, M, dk]
            mk = _split_heads(linear(levels, cblk.wk), h)
            mv = _split_heads(linear(levels, cblk.wv), h)
            q = _split_heads(linear(x, cblk.wq), h)
            q = q.reshape(nb, s, *q.shape[1:])

            def cross(e):
                ctx = _attend(q, mk[:, e, None], mv[:, e, None], src_mask, p,
                              gen).reshape(nb * s, h, T, -1)
                return linear(_merge_heads(ctx), cblk.wo)
            x = self._mesh(i, x, cross, gen)
        return torch.log_softmax(linear(x, self.generator).float(), dim=-1)
