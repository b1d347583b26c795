"""The RNN captioners: UpDown / TopDown, Att2in2 / Att2in, Att2all2,
StackAtt / DenseAtt, AdaAtt / AdaAttMO, NewFC / FC / LM, ShowTell.

Port of ``captioning_tpu/models/harness.py``: the shared
embeds of ``AttCaptioner`` (word embedding, with ReLU except for the FC
family and the legacy 'fc', 'show_tell' and 'att2in'; the fc embed as an
``MLPEmbed``, a plain Linear (NewFC / FC / ShowTell) or none; att embeds,
the optional masked BatchNorm and the ``ctx2att`` key projection for the
models with attention (att2in projects the raw regions); the logit MLP,
none for the legacy models) around a per-step core, exposing the engine's
step protocol
(``prepare_feature``, ``init_state``, ``step``) and a teacher-forced
``forward_tf``.  Train mode is the generator ``gen`` these take (None is
eval): dropout at exactly the JAX sites, drawn from ``gen``
(``layers.dropout``), the BatchNorm's batch statistics, and scheduled
sampling in ``forward_tf``.  Module and parameter names
follow the JAX tree (``core.attention.h2att``, ``core.lstm0.i2h``,
``core.h2h_0``, ``logit_hidden.0``, ...), so the weight bridge maps keys
one to one.

Two kernels run inside the cores for CUDA tensors:

* the attention heads (UpDown, Att2in2, Att2in, Att2all2, StackAtt's two;
  AoANet's with ``use_multi_head`` other than 2, ``models/aoa.py``) run
  kernel B3 (``ops.attention.additive_attention_fused``), row-aligned or
  block-shared.  For CPU tensors the head follows the JAX branch that
  ``cfg.use_pallas`` selects: the fused kernel's twin when the rows are
  aligned and ``use_pallas`` is set, the plain ``layers.additive_attention``
  otherwise;
* every maxout LSTM chain (``MaxoutLSTMCell`` of StackAtt / DenseAtt and
  the FC family, the AdaAttMO cells, the Att2in2 / Att2in / Att2all2
  cells) runs
  ``ops.lstm.maxout_lstm_gates_fused``, whose twin is the JAX chain.

AdaAtt's sentinel attention, AdaAtt's tanh cell, UpDown's torch-style
LSTM cells and ShowTell's LSTM / GRU stack are plain PyTorch, as the JAX
package left them to XLA.

Parameters are float32 masters; ``install_compute_copies`` gives the Linear
and Embedding weights their copies in ``cfg.dtype`` (``layers``; the masked
BatchNorm stays float32), and the LSTM state h / c is kept in the compute
dtype, as the JAX cells keep it.

``models/aoa.py`` builds AoANet on this harness (its step and
``forward_tf``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..ops.attention import additive_attention_fused
from ..ops.lstm import maxout_lstm_gates_fused
from .config import ModelConfig
from .layers import (Embedding, MaskedBatchNorm, MLPEmbed, additive_attention,
                     compute_param, dropout, init_dense,
                     install_compute_copies, linear, uniform_)

# words banned from preceding EOS by remove_bad_endings (reference
# AttModel.py:29-30, the JAX harness's BAD_ENDINGS)
BAD_ENDINGS = ['a', 'an', 'the', 'in', 'for', 'at', 'of', 'with', 'before',
               'after', 'on', 'upon', 'near', 'to', 'is', 'are', 'am']
# model keys served by this module; 'topdown' is UpDown
MODELS = ('updown', 'topdown', 'att2in2', 'att2in', 'att2all2', 'stackatt',
          'denseatt', 'adaatt', 'adaattmo', 'newfc', 'fc', 'language_model',
          'show_tell')
# the models whose cores read attention features only through
# AttentionHead, which takes one feats row per block of query rows (the JAX
# api's _SHARED_FEATS_RNN); AdaAtt reads them directly
SHARED_FEATS = ('updown', 'topdown', 'att2in2', 'att2in', 'att2all2',
                'stackatt', 'denseatt')
# the FC family and ShowTell: no attention features, words embedded
# without the ReLU
_NO_ATT = ('newfc', 'fc', 'language_model', 'show_tell')
# the legacy models: a U(+-0.1) word embedding without the ReLU and
# dropout, a U(+-0.1) logit with a zero bias and no hidden logit layers
_LEGACY = ('fc', 'show_tell', 'att2in')


class TorchLSTMCell(nn.Module):
    """torch nn.LSTMCell as the JAX ``TorchLSTMCell`` computes it: gate
    order i, f, g, o, every op in the compute dtype."""

    def __init__(self, in_features: int, rnn_size: int):
        super().__init__()
        self.ih = nn.Linear(in_features, 4 * rnn_size)
        self.hh = nn.Linear(rnn_size, 4 * rnn_size)

    def init_weights(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.hh.in_features)
        for lin in (self.ih, self.hh):
            uniform_(lin.weight, bound, generator)
            uniform_(lin.bias, bound, generator)

    def forward(self, x, h, c):
        H = self.hh.in_features
        s = linear(x, self.ih) + linear(h, self.hh)
        i = torch.sigmoid(s[:, :H])
        f = torch.sigmoid(s[:, H:2 * H])
        g = torch.tanh(s[:, 2 * H:3 * H])
        o = torch.sigmoid(s[:, 3 * H:])
        next_c = f * c + i * g
        return o * torch.tanh(next_c), next_c


class AttentionHead(nn.Module):
    """Additive attention head (reference AttModel.py:719-748); ``h2att``
    stays a GEMM outside the kernel, as in the JAX head."""

    def __init__(self, rnn_size: int, att_hid_size: int, use_pallas: bool):
        super().__init__()
        self.h2att = nn.Linear(rnn_size, att_hid_size)
        self.alpha_net = nn.Linear(att_hid_size, 1)
        self.use_pallas = use_pallas

    def forward(self, h, feats):
        att, p_att, masks = (feats['att_feats'], feats['p_att_feats'],
                             feats['att_masks'])
        if h.device.type != 'cpu' or (self.use_pallas and
                                      att.shape[0] == h.shape[0]):
            return additive_attention_fused(
                linear(h, self.h2att), att, p_att, masks,
                compute_param(self.alpha_net, 'weight')[0],
                compute_param(self.alpha_net, 'bias'))
        return additive_attention(h, att, p_att, masks, self.h2att,
                                  self.alpha_net)


class MaxoutLSTMCell(nn.Module):
    """The 5-gate maxout LSTM (reference FCModel.py:13-42): ``i2h`` and
    ``h2h`` stay GEMMs, the gate chain runs ``maxout_lstm_gates_fused``.
    The JAX cell's output dropout is its callers' (``StackAttCore``,
    ``FCCore``)."""

    def __init__(self, in_features: int, rnn_size: int):
        super().__init__()
        self.i2h = nn.Linear(in_features, 5 * rnn_size)
        self.h2h = nn.Linear(rnn_size, 5 * rnn_size)

    def forward(self, x, h, c):
        s = linear(x, self.i2h) + linear(h, self.h2h)
        return maxout_lstm_gates_fused(s, c.contiguous())


class Att2in2Core(nn.Module):
    """Attention feeds only the input transform, via a2c (reference
    AttModel.py:750-796).  'att2in' attends over the raw regions (no att
    embed), so its a2c reads ``att_feat_size`` wide contexts."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, H = cfg.input_encoding_size, cfg.rnn_size
        self.attention = AttentionHead(H, cfg.att_hid_size,
                                       bool(cfg.use_pallas))
        self.i2h = nn.Linear(E, 5 * H)
        self.h2h = nn.Linear(H, 5 * H)
        self.a2c = nn.Linear(cfg.att_feat_size if cfg.caption_model ==
                             'att2in' else H, 2 * H)
        self.drop = cfg.drop_prob_lm

    def forward(self, xt, feats, state, gen=None):
        H = self.h2h.in_features
        h_prev, c_prev = state['h'][:, -1], state['c'][:, -1]
        att_res = self.attention(h_prev, feats)
        s = linear(xt, self.i2h) + linear(h_prev, self.h2h)
        # the JAX in_transform = s[:, 3H:5H] + a2c(att), in s's dtype; s is
        # a fresh sum, so the add may go in place
        s[:, 3 * H:] += linear(att_res, self.a2c)
        next_h, next_c = maxout_lstm_gates_fused(s, c_prev.contiguous())
        return (dropout(next_h, self.drop, gen),
                dict(state, h=next_h[:, None], c=next_c[:, None]))


class Att2all2Core(nn.Module):
    """Attention feeds all 5H gate inputs, via a2h (reference
    AttModel.py:802-841)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, H = cfg.input_encoding_size, cfg.rnn_size
        self.attention = AttentionHead(H, cfg.att_hid_size,
                                       bool(cfg.use_pallas))
        self.i2h = nn.Linear(E, 5 * H)
        self.h2h = nn.Linear(H, 5 * H)
        self.a2h = nn.Linear(H, 5 * H)
        self.drop = cfg.drop_prob_lm

    def forward(self, xt, feats, state, gen=None):
        h_prev, c_prev = state['h'][:, -1], state['c'][:, -1]
        att_res = self.attention(h_prev, feats)
        s = (linear(xt, self.i2h) + linear(h_prev, self.h2h)
             + linear(att_res, self.a2h))
        next_h, next_c = maxout_lstm_gates_fused(s, c_prev.contiguous())
        return (dropout(next_h, self.drop, gen),
                dict(state, h=next_h[:, None], c=next_c[:, None]))


class UpDownCore(nn.Module):
    """Two-layer top-down attention LSTM (reference AttModel.py:615-640)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, H = cfg.input_encoding_size, cfg.rnn_size
        # att_lstm reads [h_lang, fc_embed(fc), xt]
        self.att_lstm = TorchLSTMCell(2 * H + E, H)
        self.attention = AttentionHead(H, cfg.att_hid_size,
                                       bool(cfg.use_pallas))
        self.lang_lstm = TorchLSTMCell(2 * H, H)
        self.drop = cfg.drop_prob_lm

    def forward(self, xt, feats, state, gen=None):
        h, c = state['h'], state['c']
        h_att, c_att = self.att_lstm(
            torch.cat([h[:, 1], feats['fc_feats'], xt], 1), h[:, 0], c[:, 0])
        att = self.attention(h_att, feats)
        h_lang, c_lang = self.lang_lstm(torch.cat([att, h_att], 1), h[:, 1],
                                        c[:, 1])
        return (dropout(h_lang, self.drop, gen),
                dict(state, h=torch.stack([h_att, h_lang], 1),
                     c=torch.stack([c_att, c_lang], 1)))


class StackAttCore(nn.Module):
    """Three maxout LSTMs and two attention heads in a chain; DenseAtt adds
    the ``MLPEmbed`` fusions (reference AttModel.py:650-717)."""

    def __init__(self, cfg: ModelConfig, dense_fusion: bool = False):
        super().__init__()
        E, H = cfg.input_encoding_size, cfg.rnn_size
        use_pallas = bool(cfg.use_pallas)
        p = self.drop = cfg.drop_prob_lm
        self.att1 = AttentionHead(H, cfg.att_hid_size, use_pallas)
        self.att2 = AttentionHead(H, cfg.att_hid_size, use_pallas)
        self.lstm0 = MaxoutLSTMCell(E + H, H)        # [xt, fc_embed(fc)]
        self.lstm1 = MaxoutLSTMCell(2 * H, H)
        self.emb2 = nn.Linear(H, H)
        self.lstm2 = MaxoutLSTMCell(2 * H, H)
        self.fusion1 = MLPEmbed(2 * H, H, p) if dense_fusion else None
        self.fusion2 = MLPEmbed(3 * H, H, p) if dense_fusion else None

    def forward(self, xt, feats, state, gen=None):
        h, c = state['h'], state['c']
        # the chain reads each cell's dropped output, the state keeps h
        h0, c0 = self.lstm0(torch.cat([xt, feats['fc_feats']], 1), h[:, 0],
                            c[:, 0])
        o0 = dropout(h0, self.drop, gen)
        att1 = self.att1(o0, feats)
        h1, c1 = self.lstm1(torch.cat([o0, att1], 1), h[:, 1], c[:, 1])
        o1 = dropout(h1, self.drop, gen)
        att2 = self.att2(o1 + linear(att1, self.emb2), feats)
        if self.fusion1 is not None:
            h2_in = torch.cat([self.fusion1(torch.cat([o0, o1], 1), gen),
                               att2], 1)
        else:
            h2_in = torch.cat([o1, att2], 1)
        h2, c2 = self.lstm2(h2_in, h[:, 2], c[:, 2])
        o2 = dropout(h2, self.drop, gen)
        out = (self.fusion2(torch.cat([o0, o1, o2], 1), gen)
               if self.fusion2 is not None else o2)
        return out, dict(state, h=torch.stack([h0, h1, h2], 1),
                         c=torch.stack([c0, c1, c2], 1))


class AdaAttCore(nn.Module):
    """Adaptive attention with a visual sentinel (reference
    AttModel.py:451-613): ``num_layers`` LSTMs, the last one also gating
    the sentinel ``fake_region``, then attention over [sentinel, regions].
    AdaAtt's cells use a tanh input transform; AdaAttMO's are maxout cells
    and run ``maxout_lstm_gates_fused``.  The sentinel joins the regions,
    so ``input_encoding_size`` must equal ``rnn_size``."""

    def __init__(self, cfg: ModelConfig, use_maxout: bool = False):
        super().__init__()
        E, H, A, L = (cfg.input_encoding_size, cfg.rnn_size,
                      cfg.att_hid_size, cfg.num_layers)
        n = (5 if use_maxout else 4) * H
        self.use_maxout = use_maxout
        self.num_layers = L
        self.drop = cfg.drop_prob_lm
        self.w2h = nn.Linear(E, n)
        self.v2h = nn.Linear(H, n)               # fc_embed(fc) is [H]
        for layer in range(L):
            if layer:
                self.add_module('i2h_%d' % (layer - 1), nn.Linear(H, n))
            self.add_module('h2h_%d' % layer, nn.Linear(H, n))
        if L == 1:
            self.r_w2h = nn.Linear(E, H)
            self.r_v2h = nn.Linear(H, H)
        else:
            self.r_i2h = nn.Linear(H, H)
        self.r_h2h = nn.Linear(H, H)
        self.fr_linear = nn.Linear(H, E)
        self.fr_embed = nn.Linear(E, A)
        self.ho_linear = nn.Linear(H, E)
        self.ho_embed = nn.Linear(E, A)
        self.alpha_net = nn.Linear(A, 1)
        self.att2h = nn.Linear(E, H)

    def _cell(self, s, c_prev):
        """(next_h, next_c, tanh(next_c)) from the gate sums s."""
        if self.use_maxout:
            next_h, next_c = maxout_lstm_gates_fused(s, c_prev.contiguous())
            return next_h, next_c, torch.tanh(next_c)
        H = c_prev.shape[-1]
        gates = torch.sigmoid(s[:, :3 * H])
        next_c = (gates[:, H:2 * H] * c_prev
                  + gates[:, :H] * torch.tanh(s[:, 3 * H:]))
        tanh_c = torch.tanh(next_c)
        return gates[:, 2 * H:] * tanh_c, next_c, tanh_c

    def forward(self, xt, feats, state, gen=None):
        p = self.drop
        img_fc = feats['fc_feats']
        hs, cs = [], []
        x = xt
        for layer in range(self.num_layers):
            prev_h, prev_c = state['h'][:, layer], state['c'][:, layer]
            if layer == 0:
                i2h = linear(x, self.w2h) + linear(img_fc, self.v2h)
            else:
                x = dropout(hs[-1], p, gen)
                i2h = linear(x, getattr(self, 'i2h_%d' % (layer - 1)))
            s = i2h + linear(prev_h, getattr(self, 'h2h_%d' % layer))
            next_h, next_c, tanh_c = self._cell(s, prev_c)
            if layer == self.num_layers - 1:
                if layer == 0:
                    r = linear(x, self.r_w2h) + linear(img_fc, self.r_v2h)
                else:
                    r = linear(x, self.r_i2h)
                n5 = r + linear(prev_h, self.r_h2h)
                fake_region = torch.sigmoid(n5) * tanh_c
            hs.append(next_h)
            cs.append(next_c)

        top_h = dropout(hs[-1], p, gen)
        fake_region = dropout(fake_region, p, gen)

        # AdaAtt_attention (reference AttModel.py:539-602)
        fr = dropout(torch.relu(linear(fake_region, self.fr_linear)), p, gen)
        fr_embed = linear(fr, self.fr_embed)
        h_out_linear = dropout(torch.tanh(linear(top_h, self.ho_linear)), p,
                               gen)
        h_out_embed = linear(h_out_linear, self.ho_embed)
        img_all = torch.cat([fr[:, None], feats['att_feats']], 1)
        img_all_embed = torch.cat([fr_embed[:, None], feats['p_att_feats']],
                                  1)
        hA = dropout(torch.tanh(img_all_embed + h_out_embed[:, None]), p, gen)
        weight = torch.softmax(linear(hA, self.alpha_net)[..., 0], dim=-1)
        masks = feats['att_masks']
        if masks is not None:
            weight = weight * torch.cat([masks[:, :1], masks], 1)
            weight = weight / weight.sum(-1, keepdim=True).clamp_min(1e-9)
        dt = torch.promote_types(weight.dtype, img_all.dtype)
        vis_att = torch.einsum('bm,bmh->bh', weight.to(dt), img_all.to(dt))
        h = dropout(torch.tanh(linear(vis_att + h_out_linear, self.att2h)), p,
                    gen)
        return h, dict(state, h=torch.stack(hs, 1), c=torch.stack(cs, 1))


class FCCore(nn.Module):
    """NewFC / FC / LM: one maxout LSTM whose state is seeded with the image
    embedding at the first step (reference AttModel.py:904-968,
    FCModel.py:79-115).  The JAX core runs the seeding cell every step and
    selects it per row where ``t == 0``.  Here, where every row shares the
    host int ``t``, the seeding cell runs once, at ``t == 0``: the same
    values; a per-row ``t`` (staggered diverse groups) runs it every step
    and selects it per row, as the JAX core.  Its output is never read, so
    it takes no dropout mask (the JAX cell draws one and drops it)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.lstm = MaxoutLSTMCell(cfg.input_encoding_size, cfg.rnn_size)
        self.drop = cfg.drop_prob_lm

    def forward(self, xt, feats, state, gen=None):
        h, c = state['h'][:, -1], state['c'][:, -1]
        t = state['t']
        if torch.is_tensor(t) or t == 0:
            h_fc, c_fc = self.lstm(feats['fc_feats'], torch.zeros_like(h),
                                   torch.zeros_like(c))
            if torch.is_tensor(t):
                first = (t == 0)[:, None]
                h_fc = torch.where(first, h_fc, h)
                c_fc = torch.where(first, c_fc, c)
            h, c = h_fc, c_fc
        next_h, next_c = self.lstm(xt, h, c)
        return (dropout(next_h, self.drop, gen),
                dict(state, h=next_h[:, None], c=next_c[:, None]))


class ShowTellCore(nn.Module):
    """``num_layers`` stacked torch LSTM or GRU cells (``rnn_type``) without
    bias (reference ShowTellModel.py:13-94), dropout between the layers and
    on the output; the state is seeded with the image embedding at the
    first step, as ``FCCore`` seeds it (the reference feeds the image as a
    step before BOS: the same computation).  The seeding pass draws the
    dropout between its layers, as the JAX core draws it.  A GRU keeps its
    c at 0."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, H, L = cfg.input_encoding_size, cfg.rnn_size, cfg.num_layers
        self.lstm = cfg.rnn_type == 'lstm'
        n = (4 if self.lstm else 3) * H
        for layer in range(L):
            self.add_module('ih_%d' % layer,
                            nn.Linear(E if layer == 0 else H, n, bias=False))
            self.add_module('hh_%d' % layer, nn.Linear(H, n, bias=False))
        self.num_layers = L
        self.drop = cfg.drop_prob_lm

    def init_weights(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.hh_0.in_features)
        for lin in self.children():
            uniform_(lin.weight, bound, generator)

    def _stack(self, x, h, c, gen):
        """(the top layer's output, h, c) of one pass up the stack."""
        H = h.shape[-1]
        hs, cs = [], []
        for layer in range(self.num_layers):
            s_x = linear(x, getattr(self, 'ih_%d' % layer))
            s_h = linear(h[:, layer], getattr(self, 'hh_%d' % layer))
            if self.lstm:
                s = s_x + s_h
                i = torch.sigmoid(s[:, :H])
                f = torch.sigmoid(s[:, H:2 * H])
                g = torch.tanh(s[:, 2 * H:3 * H])
                o = torch.sigmoid(s[:, 3 * H:])
                next_c = f * c[:, layer] + i * g
                next_h = o * torch.tanh(next_c)
            else:
                r = torch.sigmoid(s_x[:, :H] + s_h[:, :H])
                z = torch.sigmoid(s_x[:, H:2 * H] + s_h[:, H:2 * H])
                n = torch.tanh(s_x[:, 2 * H:] + r * s_h[:, 2 * H:])
                next_h = (1 - z) * n + z * h[:, layer]
                next_c = c[:, layer]
            hs.append(next_h)
            cs.append(next_c)
            x = (next_h if layer == self.num_layers - 1
                 else dropout(next_h, self.drop, gen))
        return x, torch.stack(hs, 1), torch.stack(cs, 1)

    def forward(self, xt, feats, state, gen=None):
        h, c, t = state['h'], state['c'], state['t']
        # the seeding pass at t == 0 (per row for a per-row t), as FCCore
        if torch.is_tensor(t) or t == 0:
            _, h_fc, c_fc = self._stack(feats['fc_feats'], torch.zeros_like(h),
                                        torch.zeros_like(c), gen)
            if torch.is_tensor(t):
                first = (t == 0)[:, None, None]
                h_fc = torch.where(first, h_fc, h)
                c_fc = torch.where(first, c_fc, c)
            h, c = h_fc, c_fc
        top, h, c = self._stack(xt, h, c, gen)
        return dropout(top, self.drop, gen), dict(state, h=h, c=c)


def state_num_layers(cfg: ModelConfig) -> int:
    m = cfg.caption_model
    if m in ('updown', 'topdown', 'aoa'):
        return 2
    if m in ('stackatt', 'denseatt'):
        return 3
    if m in ('adaatt', 'adaattmo', 'show_tell'):
        return cfg.num_layers
    return 1


def make_core(cfg: ModelConfig) -> nn.Module:
    m = cfg.caption_model
    if m in ('att2in2', 'att2in'):
        return Att2in2Core(cfg)
    if m == 'att2all2':
        return Att2all2Core(cfg)
    if m in ('updown', 'topdown'):
        return UpDownCore(cfg)
    if m in ('stackatt', 'denseatt'):
        return StackAttCore(cfg, dense_fusion=m == 'denseatt')
    if m in ('adaatt', 'adaattmo'):
        return AdaAttCore(cfg, use_maxout=m == 'adaattmo')
    if m in ('newfc', 'fc', 'language_model'):
        return FCCore(cfg)
    if m == 'show_tell':
        return ShowTellCore(cfg)
    raise NotImplementedError('caption model %r is not ported yet; see '
                              'ROADMAP.md' % m)


class AttCaptioner(nn.Module):
    """The attention captioner harness (reference AttModel.py:51-176) for
    the ported cores."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        m = cfg.caption_model
        E, H = cfg.input_encoding_size, cfg.rnn_size
        V1 = cfg.vocab_size + 1
        self.core = make_core(cfg)
        # the FC family, ShowTell and att2in embed words without the ReLU
        self.embed_relu = m not in _NO_ATT + _LEGACY
        self.embed = Embedding(V1, E)
        p = cfg.drop_prob_lm
        if m in ('att2in2', 'att2in', 'att2all2', 'language_model'):
            self.fc_embed = None
        elif m in ('newfc', 'fc', 'show_tell'):
            self.fc_embed = nn.Linear(cfg.fc_feat_size, E)
        else:
            self.fc_embed = MLPEmbed(cfg.fc_feat_size, H, p)
        # att2in attends over the raw regions: no att embed, no BatchNorm
        embed_att = m not in _NO_ATT + ('att2in',)
        self.att_bn_in = (MaskedBatchNorm(cfg.att_feat_size)
                          if embed_att and cfg.use_bn else None)
        self.att_embed = (MLPEmbed(cfg.att_feat_size, H, p) if embed_att
                          else None)
        self.att_bn_out = (MaskedBatchNorm(H) if embed_att and cfg.use_bn == 2
                           else None)
        self.ctx2att = (None if m in _NO_ATT else nn.Linear(
            H if embed_att else cfg.att_feat_size, cfg.att_hid_size))
        # the legacy logit has no hidden layers
        self.logit_hidden = nn.ModuleList(
            nn.Linear(H, H)
            for _ in range(0 if m in _LEGACY else cfg.logit_layers - 1))
        self.logit = nn.Linear(H, V1)

    @property
    def shared_feats(self) -> bool:
        """Whether one feats row may serve a block of query rows (beam lanes,
        seq_per_img captions): the JAX ``_SHARED_FEATS_RNN``."""
        return self.cfg.caption_model in SHARED_FEATS

    # -- parameters ----------------------------------------------------------
    def init_weights(self, generator: torch.Generator):
        """The JAX module's init, drawn from ``generator``: Dense
        U(+-1/sqrt(fan_in)), Embedding N(0, 1), LSTM / GRU U(+-1/sqrt(H));
        the legacy embedding and logit U(+-0.1) with a zero logit bias."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_dense(m, generator)
        # the cells redraw their ih / hh with the LSTM bound
        for m in self.modules():
            if isinstance(m, (Embedding, TorchLSTMCell, ShowTellCore)):
                m.init_weights(generator)
        if self.cfg.caption_model in _LEGACY:
            uniform_(self.embed.embedding, 0.1, generator)
            uniform_(self.logit.weight, 0.1, generator)
            with torch.no_grad():
                self.logit.bias.zero_()
        return self

    def install_compute_copies(self):
        """The (master, copy) pairs of the Linear and Embedding weights in
        ``cfg.dtype`` (``layers.install_compute_copies``)."""
        return install_compute_copies(self, self.cfg.dtype,
                                      (nn.Linear, Embedding))

    # -- public protocol -------------------------------------------------------
    def prepare_feature(self, fc_feats, att_feats, att_masks, gen=None):
        """reference AttModel.py:114-124 and the NewFC / LM overrides
        (:942-968).  The cores of the FC family and ShowTell read no
        attention features, so their feats carry none (the JAX tree carries
        them along unread); att2in's are the raw regions.  In
        train mode (``gen``) the BatchNorms update their running
        statistics in place."""
        cfg = self.cfg
        train = gen is not None
        if cfg.caption_model == 'language_model':
            p_fc = torch.zeros(fc_feats.shape[0], cfg.input_encoding_size,
                               dtype=cfg.dtype, device=fc_feats.device)
        elif isinstance(self.fc_embed, nn.Linear):
            p_fc = linear(fc_feats, self.fc_embed)
        elif self.fc_embed is not None:
            p_fc = self.fc_embed(fc_feats, gen)
        else:
            p_fc = fc_feats
        if self.ctx2att is None:
            return {'fc_feats': p_fc, 'att_feats': None,
                    'p_att_feats': None, 'att_masks': None}
        x = att_feats
        if self.att_bn_in is not None:
            x = self.att_bn_in(x, att_masks, train)
        if self.att_embed is not None:
            x = self.att_embed(x, gen)
        if self.att_bn_out is not None:
            x = self.att_bn_out(x, att_masks, train)
        return {'fc_feats': p_fc, 'att_feats': x,
                'p_att_feats': linear(x, self.ctx2att),
                'att_masks': att_masks}

    def init_state(self, batch_size: int, beam: bool = False) -> Dict:
        """h / c [N, L, rnn_size] in the compute dtype, and the step ``t``
        as a Python int, shared by every row, until a per-row step makes it
        a [N] tensor (FCCore seeds its state at ``t == 0``; the other cores
        are positionless).  ``beam`` is the engine's layout hint for
        KV-cached models."""
        cfg = self.cfg
        shape = (batch_size, state_num_layers(cfg), cfg.rnn_size)
        dev = self.logit.weight.device
        return {'t': 0,
                'h': torch.zeros(shape, dtype=cfg.dtype, device=dev),
                'c': torch.zeros(shape, dtype=cfg.dtype, device=dev)}

    def step(self, it, feats, state, logsoftmax: bool = True,
             uniform_t: bool = True, beam_width: int = 0, gen=None):
        """get_logprobs_state (reference AttModel.py:166-176); float32
        log-probs (or logits) [N, V+1].

        ``feats`` of a ``shared_feats`` model may hold one attention row
        per block of N // nb query rows (block-shared beam lanes or
        seq_per_img captions): the attention heads read them shared, and
        only fc_feats, which the cores consume per row, is repeated here.
        The other models get one feats row per query row.
        ``uniform_t=False`` carries ``t`` per row (a [N] tensor: FCCore
        seeds each row at its own first step); ``beam_width`` is a layout
        hint of KV-cached models, unused by an RNN state.  ``gen`` is train
        mode (dropout drawn from it)."""
        N = it.shape[0]
        if not uniform_t and not torch.is_tensor(state['t']):
            state = dict(state, t=torch.full((N,), state['t'],
                                             dtype=torch.long,
                                             device=it.device))
        af, fc = feats['att_feats'], feats['fc_feats']
        if af is not None and af.shape[0] != N and fc.shape[0] != N:
            feats = dict(feats, fc_feats=fc.repeat_interleave(
                N // fc.shape[0], dim=0))
        xt = self.embed(it)
        if self.embed_relu:
            xt = dropout(torch.relu(xt), self.cfg.drop_prob_lm, gen)
        output, state = self.core(xt, feats, state, gen)
        for lin in self.logit_hidden:
            # the reference's hidden logit layers drop at 0.5 (AttModel.py:86-92)
            output = dropout(torch.relu(linear(output, lin)), 0.5, gen)
        logits = linear(output, self.logit).float()
        state = dict(state, t=state['t'] + 1)
        if logsoftmax:
            return torch.log_softmax(logits, dim=-1), state
        return logits, state

    # -- teacher forcing ---------------------------------------------------------
    def forward_tf(self, fc_feats, att_feats, seq, att_masks, gen=None,
                   ss_prob: float = 0.0):
        """Teacher-forced log-probs [N, T, V+1] over input tokens ``seq``
        [N, T] or [B, seq_per_img, T] (reference AttModel._forward); the
        feats stay one row per image for a ``shared_feats`` model and are
        repeated per caption otherwise.  In train mode (``gen``) scheduled
        sampling follows the JAX ``Captioner.forward_tf``: from step 1 on,
        each row feeds, with probability ``ss_prob``, a token drawn from
        its previous output; the coin and the draw are made at every such
        step whatever ``ss_prob`` is."""
        if seq.dim() == 3:
            seq = seq.reshape(-1, seq.shape[2])
        feats = self.prepare_feature(fc_feats, att_feats, att_masks, gen)
        if not self.shared_feats:
            n = seq.shape[0] // fc_feats.shape[0]
            feats = {k: v if v is None else v.repeat_interleave(n, dim=0)
                     for k, v in feats.items()}
        state = self.init_state(seq.shape[0])
        out = []
        for t in range(seq.shape[1]):
            it = seq[:, t]
            if gen is not None and t:
                it = scheduled_sample(it, out[-1], ss_prob, gen)
            lp, state = self.step(it, feats, state, gen=gen)
            out.append(lp)
        return torch.stack(out, 1)


def scheduled_sample(it, prev_logprobs, ss_prob, gen):
    """Each row's input: ``it`` or, where a uniform draw is below
    ``ss_prob`` (a float or a 0-d tensor), a token drawn from
    ``prev_logprobs`` [N, V+1] (the coin first, then the draw, both from
    ``gen``; no gradient).  The draw is ``torch.multinomial``'s one-sample
    algorithm written out, argmax(p / q) with q ~ Exp(1): the same token
    from the same generator state, without the host read by which
    ``multinomial`` checks its input, which a CUDA graph cannot hold."""
    with torch.no_grad():
        coin = torch.rand(it.shape[0], generator=gen,
                          device=it.device) < ss_prob
        probs = prev_logprobs.exp()
        q = torch.empty_like(probs).exponential_(1, generator=gen)
        drawn = (probs / q).argmax(-1)
    return torch.where(coin, drawn.to(it.dtype), it)
