"""Attention-on-Attention captioner (AoANet).

Port of ``captioning_tpu/models/aoa.py``: multi-headed dot attention with
a GLU "attention on attention" gate (``MultiHeadedDotAttention``), a
6-layer pre-norm refiner over the embedded regions (``AoARefiner``), and a
decoder core of an attention LSTM, a dot attention over the refined
regions and an AoA / LSTM / plain output layer, whose context vector rides
in state slot 1 (``AoACaptioner``).  The masked mean of the refined
regions replaces the fc feature (``mean_feats``).

``AoACaptioner`` is an ``AttCaptioner``: it shares the harness's word
embedding, step (the block-shared fc expansion, the logit, ``t``) and
teacher-forced scan (``forward_tf`` with scheduled sampling), and brings
its own modules, ``prepare_feature`` and per-step ``core``.  Module and
parameter names follow the JAX tree (``refiner.attn_0.q``,
``attention.norm``, ``att_lstm.ih``, ``att2ctx``), so the weight bridge
maps keys one to one.

The attention is plain PyTorch (einsums, softmax in float32), as in the
JAX package; with ``use_multi_head`` other than 2 the decoder attends
through the harness's ``AttentionHead``, which runs kernel B3 for CUDA
tensors.  The beam's top-k over ``[B, beam x V1]`` is the engine's (B6).

Train mode is the generator ``gen`` (None is eval).  Dropout at the JAX
sites: the MLP embeds and the word embedding at ``drop_prob_lm``; the
refiner's attention probabilities, residuals and feed-forward, and the
decoder attention's probabilities at ``DROPOUT`` (the JAX module's literal
0.1); the AoA gate's input at ``dropout_aoa``; ``ctx_drop`` on the
previous context and the output at ``drop_prob_lm``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.beam_attend import sqrt_in
from .config import ModelConfig
from .harness import AttCaptioner, AttentionHead, TorchLSTMCell
from .layers import Embedding, MaskedBatchNorm, MLPEmbed, dropout, linear
from .transformer import (_NEG_INF, RefLayerNorm, _attend, _merge_heads,
                          _softmax_f32, _split_heads)

# the rate of the refiner's and the decoder attention's fixed dropout sites
DROPOUT = 0.1


def _attend_shared(q, k, v, mask, p: float = 0.0, gen=None):
    """Attention where one K/V row serves a block of query rows (the beam
    lanes or the seq_per_img captions of one image; the JAX
    ``transformer._attend_shared``).  q: [nb, bw, h, dk]; k / v: [nb, h, M,
    dk]; mask: [nb, M] or None.  Returns [nb * bw, h, 1, dk]."""
    nb, bw, h, dk = q.shape
    scores = torch.einsum('bqhd,bhmd->bqhm', q, k) / sqrt_in(dk, q.dtype)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, None, :] == 0, _NEG_INF)
    pr = dropout(_softmax_f32(scores, q.dtype), p, gen)
    return torch.einsum('bqhm,bhmd->bqhd', pr, v).reshape(nb * bw, h, 1, dk)


class MultiHeadedDotAttention(nn.Module):
    """reference AoAModel.py:17-98: an optional query LayerNorm, the query
    projection, optional K / V projections, scaled dot attention, then the
    AoA gate (a GLU over [attended, query]) or an output layer or
    nothing.  A value with fewer rows than the query is block-shared (one
    K/V row per block of single-step query rows)."""

    def __init__(self, h: int, d_model: int, dropout: float = 0.1,
                 scale: int = 1, project_k_v: int = 1,
                 use_output_layer: int = 1, do_aoa: int = 0, norm_q: int = 0,
                 dropout_aoa: float = 0.3):
        super().__init__()
        d_scaled = d_model * scale
        self.h, self.d_model = h, d_model
        self.p, self.p_aoa = dropout, dropout_aoa
        self.norm = RefLayerNorm(d_model) if norm_q else None
        self.q = nn.Linear(d_model, d_scaled)
        self.k = nn.Linear(d_model, d_scaled) if project_k_v else None
        self.v = nn.Linear(d_model, d_scaled) if project_k_v else None
        self.aoa = (nn.Linear(d_scaled + d_model, 2 * d_model) if do_aoa
                    else None)
        self.out = (nn.Linear(d_scaled, d_model)
                    if use_output_layer and not do_aoa else None)

    def forward(self, query, value, key, mask, gen=None):
        shared_kv = value.shape[0] != query.shape[0]
        raw_mask = mask
        if mask is not None and not shared_kv:
            if mask.dim() == 2:
                mask = mask[:, None, :]
            mask = mask[:, None]                      # the head dim
        single_query = query.dim() == 2
        if single_query:
            query = query[:, None]
        if self.norm is not None:
            query = self.norm(query)
        q = _split_heads(linear(query, self.q), self.h)
        if self.k is not None:
            k = _split_heads(linear(key, self.k), self.h)
            v = _split_heads(linear(value, self.v), self.h)
        else:
            k, v = _split_heads(key, self.h), _split_heads(value, self.h)
        if shared_kv:
            nb = k.shape[0]
            x = _merge_heads(_attend_shared(
                q.reshape(nb, q.shape[0] // nb, self.h, -1), k, v, raw_mask,
                self.p, gen))
        else:
            x = _merge_heads(_attend(q, k, v, mask, self.p, gen))
        if self.aoa is not None:
            D = self.d_model
            g = linear(dropout(torch.cat([x, query], -1), self.p_aoa, gen),
                       self.aoa)
            x = g[..., :D] * torch.sigmoid(g[..., D:])
        elif self.out is not None:
            x = linear(x, self.out)
        return x[:, 0] if single_query else x


class AoARefiner(nn.Module):
    """The 6 pre-norm self-attention layers over the embedded regions, each
    with an optional feed-forward (``use_ff``), then a LayerNorm
    (reference AoAModel.py:100-126)."""

    LAYERS = 6

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        D = cfg.rnn_size
        self.use_ff = bool(cfg.use_ff)
        self.p = DROPOUT
        for i in range(self.LAYERS):
            self.add_module('norm1_%d' % i, RefLayerNorm(D))
            self.add_module('attn_%d' % i, MultiHeadedDotAttention(
                cfg.num_heads, D, dropout=DROPOUT,
                scale=cfg.multi_head_scale, project_k_v=1,
                do_aoa=cfg.refine_aoa, norm_q=0,
                dropout_aoa=cfg.dropout_aoa))
            if self.use_ff:
                self.add_module('norm2_%d' % i, RefLayerNorm(D))
                self.add_module('ff1_%d' % i, nn.Linear(D, 2048))
                self.add_module('ff2_%d' % i, nn.Linear(2048, D))
        self.norm_out = RefLayerNorm(D)

    def forward(self, x, mask, gen=None):
        p = self.p
        for i in range(self.LAYERS):
            y = getattr(self, 'norm1_%d' % i)(x)
            y = getattr(self, 'attn_%d' % i)(y, y, y, mask, gen)
            x = x + dropout(y, p, gen)
            if self.use_ff:
                y = getattr(self, 'norm2_%d' % i)(x)
                y = linear(y, getattr(self, 'ff1_%d' % i))
                y = linear(dropout(torch.relu(y), p, gen),
                           getattr(self, 'ff2_%d' % i))
                x = x + dropout(y, p, gen)
        return self.norm_out(x)


class AoACaptioner(AttCaptioner):
    """AoANet on the harness's step protocol (reference AoAModel.py:128-226).

    State h / c [N, 2, rnn_size]: slot 0 the attention LSTM's, slot 1 the
    context vector (the decoder's output before ``out_res``) and, for the
    'LSTM' decoder, its cell.  feats: ``fc_feats`` the masked mean of the
    refined regions (or the fc embed, ``mean_feats`` 0), ``att_feats`` the
    refined regions, ``p_att_feats`` their ``ctx2att`` projection (with
    ``use_multi_head`` 2 the V half then the K half of the decoder's dot
    attention).  One feats row may serve a block of query rows (beam lanes,
    seq_per_img captions): the attention reads it shared and the
    harness's step repeats only the per-row mean feats."""

    def __init__(self, cfg: ModelConfig):
        # the harness's step and scan, not its modules: AoA builds its own
        nn.Module.__init__(self)
        self.cfg = cfg
        E, D = cfg.input_encoding_size, cfg.rnn_size
        p = cfg.drop_prob_lm
        multi = cfg.use_multi_head == 2
        # the decoder attention's output width
        width = cfg.multi_head_scale * D if multi else D
        self.embed = Embedding(cfg.vocab_size + 1, E)
        self.embed_relu = True
        self.att_bn_in = (MaskedBatchNorm(cfg.att_feat_size) if cfg.use_bn
                          else None)
        self.att_embed = MLPEmbed(cfg.att_feat_size, D, p)
        self.att_bn_out = MaskedBatchNorm(D) if cfg.use_bn == 2 else None
        self.ctx2att = nn.Linear(D, 2 * width if multi else cfg.att_hid_size)
        self.fc_embed = (None if cfg.mean_feats
                         else MLPEmbed(cfg.fc_feat_size, D, p))
        self.refiner = AoARefiner(cfg) if cfg.refine else None
        self.logit_hidden = nn.ModuleList()
        self.logit = nn.Linear(D, cfg.vocab_size + 1)
        self.att_lstm = TorchLSTMCell(E + D, D)
        if multi:
            self.attention = MultiHeadedDotAttention(
                cfg.num_heads, D, dropout=DROPOUT,
                scale=cfg.multi_head_scale, project_k_v=0,
                use_output_layer=0, do_aoa=0, norm_q=1)
        else:
            self.attention = AttentionHead(D, cfg.att_hid_size, False)
        if cfg.decoder_type == 'LSTM':
            self.att2ctx_lstm = TorchLSTMCell(width + D, D)
        else:
            self.att2ctx = nn.Linear(
                width + D, 2 * D if cfg.decoder_type == 'AoA' else D)

    @property
    def shared_feats(self) -> bool:
        """The JAX ``SUPPORTS_SHARED_BEAM_FEATS``: every attention route
        reads one feats row per block of query rows."""
        return True

    def prepare_feature(self, fc_feats, att_feats, att_masks, gen=None):
        """reference AoAModel._prepare_feature (:207-226).  In train mode
        (``gen``) the BatchNorms update their running statistics in
        place."""
        cfg = self.cfg
        train = gen is not None
        x = att_feats
        if self.att_bn_in is not None:
            x = self.att_bn_in(x, att_masks, train)
        x = self.att_embed(x, gen)
        if self.att_bn_out is not None:
            x = self.att_bn_out(x, att_masks, train)
        if self.refiner is not None:
            x = self.refiner(x, att_masks, gen)
        if not cfg.mean_feats:
            mean_feats = self.fc_embed(fc_feats, gen)
        elif att_masks is None:
            mean_feats = x.mean(1)
        else:
            m = att_masks[..., None]
            mean_feats = (x * m).sum(1) / m.sum(1).clamp_min(1e-9)
        return {'fc_feats': mean_feats, 'att_feats': x,
                'p_att_feats': linear(x, self.ctx2att),
                'att_masks': att_masks}

    def core(self, xt, feats, state, gen=None):
        """AoA_Decoder_Core (reference AoAModel.py:163-186): the harness's
        step calls it with the embedded word; returns the dropped output
        and the new state."""
        cfg = self.cfg
        D = cfg.rnn_size
        p = cfg.drop_prob_lm
        h, c = state['h'], state['c']
        prev_ctx = h[:, 1]
        if cfg.ctx_drop:
            prev_ctx = dropout(prev_ctx, p, gen)
        h_att, c_att = self.att_lstm(
            torch.cat([xt, feats['fc_feats'] + prev_ctx], 1), h[:, 0],
            c[:, 0])
        if cfg.use_multi_head == 2:
            pa = feats['p_att_feats']
            half = cfg.multi_head_scale * D
            att = self.attention(h_att, pa[..., :half], pa[..., half:],
                                 feats['att_masks'], gen)
        else:
            att = self.attention(h_att, feats)
        ctx_input = torch.cat([att, h_att], 1)
        if cfg.decoder_type == 'LSTM':
            output, c_ctx = self.att2ctx_lstm(ctx_input, h[:, 1], c[:, 1])
        elif cfg.decoder_type == 'AoA':
            g = linear(ctx_input, self.att2ctx)
            output, c_ctx = g[:, :D] * torch.sigmoid(g[:, D:]), c[:, 1]
        else:
            output = torch.relu(linear(ctx_input, self.att2ctx))
            c_ctx = c[:, 1]
        # slot 1 keeps the context before the residual
        state = dict(state, h=torch.stack([h_att, output], 1),
                     c=torch.stack([c_att, c_ctx], 1))
        if cfg.out_res:
            output = output + h_att
        return dropout(output, p, gen), state
