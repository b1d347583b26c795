"""The RNN attention captioners (eval): UpDown / TopDown, Att2in2, Att2all2.

Port of the eval paths of ``captioning_tpu/models/harness.py``: the shared
embeds of ``AttCaptioner`` (word embedding with ReLU, fc / att embeds, the
optional masked BatchNorm, the ``ctx2att`` key projection, the logit MLP)
around a per-step core, exposing the engine's step protocol
(``prepare_feature``, ``init_state``, ``step``) and an eval ``forward_tf``.
There is no dropout: nothing here trains yet.  Module and parameter names
follow the JAX tree (``core.attention.h2att``, ``logit_hidden.0``, ...), so
the weight bridge maps keys one to one.

The attention head runs kernel B3 (``ops.attention.additive_attention_fused``)
for CUDA tensors, row-aligned or block-shared.  For CPU tensors it follows
the JAX branch that ``cfg.use_pallas`` selects: the fused kernel's twin
when the rows are aligned and ``use_pallas`` is set, the plain
``layers.additive_attention`` otherwise.

Parameters are float32; ``to_compute_dtype`` casts the Linear and Embedding
weights to ``cfg.dtype`` (the masked BatchNorm stays float32), and the LSTM
state h / c is kept in the compute dtype, as the JAX cells keep it.

StackAtt / DenseAtt, AdaAtt, FC / NewFC / ShowTell and att2in are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..ops.attention import additive_attention_fused
from .config import ModelConfig
from .layers import (Embedding, MaskedBatchNorm, MLPEmbed, additive_attention,
                     init_dense, linear, uniform_)

# model keys served by this module; 'topdown' is UpDown
MODELS = ('updown', 'topdown', 'att2in2', 'att2all2')


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
                self.alpha_net.weight[0], self.alpha_net.bias)
        return additive_attention(h, att, p_att, masks, self.h2att,
                                  self.alpha_net)


def _maxout_cell(s, in_a, in_b, c_prev, H: int):
    """The att2in2 / att2all2 cell: sigmoid gates from s [N, 3H], the
    input transform max(in_a, in_b)."""
    gates = torch.sigmoid(s[:, :3 * H])
    next_c = (gates[:, H:2 * H] * c_prev
              + gates[:, :H] * torch.maximum(in_a, in_b))
    return gates[:, 2 * H:3 * H] * torch.tanh(next_c), next_c


class Att2in2Core(nn.Module):
    """Attention feeds only the input transform, via a2c (reference
    AttModel.py:750-796)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, H = cfg.input_encoding_size, cfg.rnn_size
        self.attention = AttentionHead(H, cfg.att_hid_size,
                                       bool(cfg.use_pallas))
        self.i2h = nn.Linear(E, 5 * H)
        self.h2h = nn.Linear(H, 5 * H)
        self.a2c = nn.Linear(H, 2 * H)

    def forward(self, xt, feats, state):
        H = self.h2h.in_features
        h_prev, c_prev = state['h'][:, -1], state['c'][:, -1]
        att_res = self.attention(h_prev, feats)
        s = linear(xt, self.i2h) + linear(h_prev, self.h2h)
        in_t = s[:, 3 * H:] + linear(att_res, self.a2c)
        next_h, next_c = _maxout_cell(s, in_t[:, :H], in_t[:, H:], c_prev, H)
        return next_h, dict(state, h=next_h[:, None], c=next_c[:, None])


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

    def forward(self, xt, feats, state):
        H = self.h2h.in_features
        h_prev, c_prev = state['h'][:, -1], state['c'][:, -1]
        att_res = self.attention(h_prev, feats)
        s = (linear(xt, self.i2h) + linear(h_prev, self.h2h)
             + linear(att_res, self.a2h))
        next_h, next_c = _maxout_cell(s, s[:, 3 * H:4 * H], s[:, 4 * H:],
                                      c_prev, H)
        return next_h, dict(state, h=next_h[:, None], c=next_c[:, None])


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

    def forward(self, xt, feats, state):
        h, c = state['h'], state['c']
        h_att, c_att = self.att_lstm(
            torch.cat([h[:, 1], feats['fc_feats'], xt], 1), h[:, 0], c[:, 0])
        att = self.attention(h_att, feats)
        h_lang, c_lang = self.lang_lstm(torch.cat([att, h_att], 1), h[:, 1],
                                        c[:, 1])
        return h_lang, dict(state, h=torch.stack([h_att, h_lang], 1),
                            c=torch.stack([c_att, c_lang], 1))


def state_num_layers(cfg: ModelConfig) -> int:
    return 2 if cfg.caption_model in ('updown', 'topdown') else 1


def make_core(cfg: ModelConfig) -> nn.Module:
    m = cfg.caption_model
    if m == 'att2in2':
        return Att2in2Core(cfg)
    if m == 'att2all2':
        return Att2all2Core(cfg)
    if m in ('updown', 'topdown'):
        return UpDownCore(cfg)
    raise NotImplementedError('caption model %r is not ported yet; see '
                              'ROADMAP.md' % m)


class AttCaptioner(nn.Module):
    """The attention captioner harness (reference AttModel.py:51-176) for
    the ported cores."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        E, H = cfg.input_encoding_size, cfg.rnn_size
        V1 = cfg.vocab_size + 1
        self.core = make_core(cfg)
        self.embed = Embedding(V1, E)
        self.fc_embed = (MLPEmbed(cfg.fc_feat_size, H)
                         if cfg.caption_model in ('updown', 'topdown')
                         else None)
        self.att_bn_in = (MaskedBatchNorm(cfg.att_feat_size) if cfg.use_bn
                          else None)
        self.att_embed = MLPEmbed(cfg.att_feat_size, H)
        self.att_bn_out = MaskedBatchNorm(H) if cfg.use_bn == 2 else None
        self.ctx2att = nn.Linear(H, cfg.att_hid_size)
        self.logit_hidden = nn.ModuleList(
            nn.Linear(H, H) for _ in range(cfg.logit_layers - 1))
        self.logit = nn.Linear(H, V1)

    # -- parameters ----------------------------------------------------------
    def init_weights(self, generator: torch.Generator):
        """The JAX module's init, drawn from ``generator``: Dense
        U(+-1/sqrt(fan_in)), Embedding N(0, 1), LSTM U(+-1/sqrt(H))."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_dense(m, generator)
        # the cells redraw their ih / hh with the LSTM bound
        for m in self.modules():
            if isinstance(m, (Embedding, TorchLSTMCell)):
                m.init_weights(generator)
        return self

    def to_compute_dtype(self):
        dt = self.cfg.dtype
        for m in self.modules():
            if isinstance(m, (nn.Linear, Embedding)):
                m.to(dt)
        return self

    # -- public protocol -------------------------------------------------------
    def prepare_feature(self, fc_feats, att_feats, att_masks):
        """reference AttModel.py:114-124."""
        p_fc = fc_feats if self.fc_embed is None else self.fc_embed(fc_feats)
        x = att_feats
        if self.att_bn_in is not None:
            x = self.att_bn_in(x, att_masks)
        x = self.att_embed(x)
        if self.att_bn_out is not None:
            x = self.att_bn_out(x, att_masks)
        return {'fc_feats': p_fc, 'att_feats': x,
                'p_att_feats': linear(x, self.ctx2att),
                'att_masks': att_masks}

    def init_state(self, batch_size: int) -> Dict:
        """h / c [N, L, rnn_size] in the compute dtype, and the step ``t``
        as a Python int (nothing here reads it: the state is
        positionless)."""
        cfg = self.cfg
        shape = (batch_size, state_num_layers(cfg), cfg.rnn_size)
        dev = self.logit.weight.device
        return {'t': 0,
                'h': torch.zeros(shape, dtype=cfg.dtype, device=dev),
                'c': torch.zeros(shape, dtype=cfg.dtype, device=dev)}

    def step(self, it, feats, state, logsoftmax: bool = True,
             uniform_t: bool = True, beam_width: int = 0):
        """get_logprobs_state (reference AttModel.py:166-176); float32
        log-probs (or logits) [N, V+1].

        ``feats`` may hold one attention row per block of N // nb query
        rows (block-shared beam lanes or seq_per_img captions): the
        attention head reads them shared, and only fc_feats, which the
        cores consume per row, is repeated here.  ``uniform_t`` and
        ``beam_width`` are layout hints of KV-cached models, unused by a
        positionless RNN state."""
        N = it.shape[0]
        af, fc = feats['att_feats'], feats['fc_feats']
        if af.shape[0] != N and fc.shape[0] != N:
            feats = dict(feats, fc_feats=fc.repeat_interleave(
                N // fc.shape[0], dim=0))
        xt = torch.relu(self.embed(it))
        output, state = self.core(xt, feats, state)
        for lin in self.logit_hidden:
            output = torch.relu(linear(output, lin))
        logits = linear(output, self.logit).float()
        state = dict(state, t=state['t'] + 1)
        if logsoftmax:
            return torch.log_softmax(logits, dim=-1), state
        return logits, state

    # -- teacher forcing (eval) ------------------------------------------------
    def forward_tf(self, fc_feats, att_feats, seq, att_masks):
        """Eval teacher-forced log-probs [N, T, V+1] over input tokens
        ``seq`` [N, T] or [B, seq_per_img, T] (reference AttModel._forward
        without scheduled sampling); the feats stay one row per image."""
        if seq.dim() == 3:
            seq = seq.reshape(-1, seq.shape[2])
        feats = self.prepare_feature(fc_feats, att_feats, att_masks)
        state = self.init_state(seq.shape[0])
        out = []
        for t in range(seq.shape[1]):
            lp, state = self.step(seq[:, t], feats, state)
            out.append(lp)
        return torch.stack(out, 1)
