"""BERT-style captioner.

Port of ``captioning_tpu/models/bert_cap.py``: a BERT encoder over the
embedded regions and a BERT decoder with causal self-attention and
cross-attention, learned word, position and type embeddings, and post-LN
blocks with an exact-gelu feed-forward.  The math is the JAX module's:

* ``BertLayerNorm`` is float32 with the *biased* variance and eps 1e-12
  added to it (not the transformer's ``RefLayerNorm``);
* the embeddings are word + position + type, then the embedding
  LayerNorm, then dropout; the position table has ``max(L + 4, 17)`` rows
  and a per-row position past it takes its last row, as the JAX gather
  clamps;
* the step's hidden goes to the vocab projection with no final norm.

The decode step is ``transformer.CachedDecoder``'s: merged-lane caches
``[N, Tp, D]``, the uniform eval step's self-attention through B1
(``attend_write_merged``), the per-row and train steps through
``_attend_rows``, and the folded cross-attention (``lazy_cross``) over one
memory row per beam block.  ``forward_tf`` runs the cross-attention
grouped over one image's ``seq_per_img`` rows.

Module and parameter names follow the JAX tree (``enc_self_0.wq``,
``dec_ffn_1.ln``, ``word_embed``, ``embed_ln``), so the weight bridge maps
keys one to one.  Parameters are float32 masters; the Linear weights and
``word_embed`` get compute-dtype copies (``layers``), while ``pos_embed``,
``type_embed`` and the LayerNorms stay float32 and are cast after the
gather, as the JAX module casts them.

Train mode is the generator ``gen`` (None is eval).  Dropout at the JAX
sites: the att embed at ``drop_prob_lm``; at ``dropout`` the embedding
output, the attention probabilities of the self- and cross-attention,
each ``wo`` output and the feed-forward's output.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .config import ModelConfig
from .layers import (MaskedBatchNorm, MLPEmbed, compute_param, dropout,
                     init_dense, install_compute_copies, linear)
from .transformer import (CachedDecoder, _attend, _Lin, _merge_heads,
                          _split_heads, fold_query, lazy_cross, pos_rows,
                          tf_masks)


class BertLayerNorm(nn.Module):
    """LayerNorm in float32 with the biased variance, eps added to it;
    returns the input's dtype."""

    def __init__(self, c: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).pow(2).mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


class BertAttnBlock(nn.Module):
    """The Q/K/V/output projections of one attention and its post-LN
    residual."""

    norm = BertLayerNorm

    def __init__(self, D: int):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (nn.Linear(D, D)
                                              for _ in range(4))
        self.ln = self.norm(D)

    def residual(self, x, ctx, p: float, gen):
        """ln(x + dropout(wo(ctx))): the block's output from the merged
        contexts."""
        return self.ln(x + dropout(linear(ctx, self.wo), p, gen))

    def attend(self, x, k, v, mask, h: int, p: float = 0.0, gen=None):
        """The block over pre-projected K / V [..., h, Tk, dk] (the JAX
        ``_attn``)."""
        q = _split_heads(linear(x, self.wq), h)
        return self.residual(x, _merge_heads(_attend(q, k, v, mask, p, gen)),
                             p, gen)


class BertFFNBlock(nn.Module):
    def __init__(self, D: int, F_: int):
        super().__init__()
        self.w_in, self.w_out = nn.Linear(D, F_), nn.Linear(F_, D)
        self.ln = BertLayerNorm(D)

    def forward(self, x, p: float = 0.0, gen=None):
        y = F.gelu(linear(x, self.w_in))            # exact (erf) gelu
        return self.ln(x + dropout(linear(y, self.w_out), p, gen))


class BertCaptioner(CachedDecoder):
    """BERT encoder-decoder captioner exposing the engine step protocol."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.att_bn_in = MaskedBatchNorm(cfg.att_feat_size) \
            if cfg.use_bn else None
        self.att_embed = MLPEmbed(cfg.att_feat_size, D, cfg.drop_prob_lm)
        self.att_bn_out = MaskedBatchNorm(D) if cfg.use_bn == 2 else None
        for i in range(cfg.N_enc):
            self.add_module('enc_self_%d' % i, BertAttnBlock(D))
            self.add_module('enc_ffn_%d' % i, BertFFNBlock(D, cfg.d_ff))
        for i in range(cfg.N_dec):
            self.add_module('dec_self_%d' % i, BertAttnBlock(D))
            self.add_module('dec_cross_%d' % i, BertAttnBlock(D))
            self.add_module('dec_ffn_%d' % i, BertFFNBlock(D, cfg.d_ff))
        V1 = cfg.vocab_size + 1
        self.word_embed = nn.Parameter(torch.zeros(V1, D))
        self.pos_embed = nn.Parameter(torch.zeros(
            max(cfg.seq_length + 4, 17), D))
        self.type_embed = nn.Parameter(torch.zeros(1, D))
        self.embed_ln = BertLayerNorm(D)
        self.generator = _Lin(D, V1)

    def _blk(self, name: str, i: int):
        return getattr(self, '%s_%d' % (name, i))

    # -- parameters ----------------------------------------------------------
    def init_weights(self, generator: torch.Generator):
        """The JAX module's init, drawn from ``generator``: Dense
        U(+-1/sqrt(fan_in)), the generator's kernel xavier-uniform, the
        embeddings N(0, 0.02)."""
        for m in self.modules():
            if isinstance(m, _Lin):
                m.init_weights(generator)
            elif isinstance(m, nn.Linear):
                init_dense(m, generator)
        with torch.no_grad():
            for w in (self.word_embed, self.pos_embed, self.type_embed):
                w.normal_(0.0, 0.02, generator=generator)
        return self

    def install_compute_copies(self):
        return install_compute_copies(self, self.cfg.dtype, nn.Linear,
                                      extra=('word_embed',))

    def _embed(self, ids, pos, gen):
        """word + position rows ``pos`` + type, each cast to the compute
        dtype (the word table before its gather), then the embedding
        LayerNorm and dropout."""
        dt = self.cfg.dtype
        x = compute_param(self, 'word_embed')[ids].to(dt)
        x = x + pos.to(dt) + self.type_embed[0].to(dt)
        return dropout(self.embed_ln(x), self.cfg.dropout, gen)

    # -- encoder -------------------------------------------------------------
    def encode(self, att_feats, att_masks, gen=None):
        cfg = self.cfg
        h, p = cfg.num_att_heads, cfg.dropout
        train = gen is not None
        x = att_feats
        if self.att_bn_in is not None:
            x = self.att_bn_in(x, att_masks, train)
        x = self.att_embed(x, gen)
        if self.att_bn_out is not None:
            x = self.att_bn_out(x, att_masks, train)
        mask = None if att_masks is None else att_masks[:, None, None, :]
        for i in range(cfg.N_enc):
            blk = self._blk('enc_self', i)
            k = _split_heads(linear(x, blk.wk), h)
            v = _split_heads(linear(x, blk.wv), h)
            x = blk.attend(x, k, v, mask, h, p, gen)
            x = self._blk('enc_ffn', i)(x, p, gen)
        return x

    def prepare_feature(self, fc_feats, att_feats, att_masks, gen=None):
        # decode steps attend the raw memory with the cross K/V projections
        # folded around the attention (lazy_cross)
        return {'memory': self.encode(att_feats, att_masks, gen),
                'att_masks': att_masks}

    # -- decode step -----------------------------------------------------------
    def _embed_step(self, it, t, gen):
        return self._embed(it, pos_rows(self.pos_embed, t), gen)

    def _layer(self, i, x, attend, feats, gen):
        """Decoder layer i of a step (post-LN): the self-attention through
        ``attend``, the folded cross-attention, the feed-forward."""
        h, p = self.cfg.num_att_heads, self.cfg.dropout
        blk = self._blk('dec_self', i)
        x = blk.residual(x, attend(linear(x, blk.wq), linear(x, blk.wk),
                                   linear(x, blk.wv)), p, gen)
        cblk = self._blk('dec_cross', i)
        mem = feats['memory']
        y = lazy_cross(fold_query(x, cblk.wq, cblk.wk, h, mem.dtype), mem,
                       feats['att_masks'], cblk.wv, cblk.wo, h, p, gen)
        x = cblk.ln(x + dropout(y, p, gen))
        return self._blk('dec_ffn', i)(x, p, gen)

    # -- teacher forcing ---------------------------------------------------------
    def forward_tf(self, fc_feats, att_feats, seq, att_masks, gen=None,
                   ss_prob: float = 0.0):
        """Teacher-forced log-probs [N, T, V+1] over input tokens ``seq``,
        in train mode given ``gen``; the ``seq_per_img`` rows of an image
        attend its memory row grouped.  ``ss_prob`` is unused, as in the
        JAX module."""
        cfg = self.cfg
        h, p = cfg.num_att_heads, cfg.dropout
        if seq.dim() == 3:
            seq = seq.reshape(-1, seq.shape[2])
        memory = self.encode(att_feats, att_masks, gen)
        nb = memory.shape[0]
        s = seq.shape[0] // nb
        T = seq.shape[1]
        tgt_mask = tf_masks(seq, cfg)
        src_mask = (None if att_masks is None
                    else att_masks[:, None, None, None, :])
        x = self._embed(seq, self.pos_embed[:T], gen)
        for i in range(cfg.N_dec):
            blk = self._blk('dec_self', i)
            k = _split_heads(linear(x, blk.wk), h)
            v = _split_heads(linear(x, blk.wv), h)
            x = blk.attend(x, k, v, tgt_mask, h, p, gen)
            cblk = self._blk('dec_cross', i)
            mk = _split_heads(linear(memory, cblk.wk), h)[:, None]
            mv = _split_heads(linear(memory, cblk.wv), h)[:, None]
            q = _split_heads(linear(x, cblk.wq), h)
            ctx = _attend(q.reshape(nb, s, *q.shape[1:]), mk, mv, src_mask,
                          p, gen).reshape(nb * s, h, T, -1)
            x = cblk.residual(x, _merge_heads(ctx), p, gen)
            x = self._blk('dec_ffn', i)(x, p, gen)
        return torch.log_softmax(linear(x, self.generator).float(), dim=-1)
