"""Plain float32 reference of the transformer captioner
(``configs/transformer/transformer.yml``: the annotated transformer of
upstream ImageCaptioning.pytorch's ``TransformerModel``, pre-LN).

* att_embed: Linear(att_feat_size -> d_model), ReLU;
* N_enc encoder layers, each ``x + MHA(LN(x))`` then ``x + FFN(LN(x))``,
  a final LayerNorm; the LayerNorm of the model family (unbiased std,
  eps on the std);
* the decoder over input tokens: the token embedding times
  sqrt(d_model) plus the sinusoidal position table, N_dec layers of
  causal self-attention, cross-attention over the encoder's memory and
  the FFN (each pre-LN with its residual), a final LayerNorm, the vocab
  projection and a log-softmax.

Every position attends to every earlier one: a decode step with a cache
does the same, so the log-probs of position t are those the decoding
step t computes.  Dropout is 0 here (the benchmark's configurations set
it to 0: this file cannot draw the program's masks).  The weights are the
checkpoint's (``model.npz`` names, kernels [in, out], layer weights
stacked [L, ...]).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import layer_norm


def layout(opt, init):
    """{checkpoint name: (shape, mean, std)} of the weights the benchmark
    draws: kernels N(0, 1 / fan_in) (the vocab projection's std times
    ``init['logit_gain']``), biases N(0, bias_std^2), LayerNorm gains
    N(1, norm_std^2) and shifts N(0, norm_std^2), the token embedding
    N(0, 1 / d_model) (the model scales it by sqrt(d_model))."""
    D, F, V1 = opt['d_model'], opt['d_ff'], opt['vocab_size'] + 1
    A = opt['att_feat_size']
    bs, ns = init['bias_std'], init['norm_std']
    out = {}

    def dense(name, fin, fout, lead=(), gain=1.0):
        out['params/%s' % name.format('kernel')] = (
            lead + (fin, fout), 0.0, gain / math.sqrt(fin))
        out['params/%s' % name.format('bias')] = (lead + (fout,), 0.0, bs)

    dense('att_embed/Dense_0/{}', A, D)
    for part, L, names in (
            ('enc', opt['N_enc'], ('self_wq', 'self_wk', 'self_wv',
                                   'self_wo')),
            ('dec', opt['N_dec'], ('self_wq', 'self_wk', 'self_wv',
                                   'self_wo', 'src_wq', 'src_wk', 'src_wv',
                                   'src_wo'))):
        for n in names:
            dense('%s_%s_{}' % (part, n), D, D, (L,))
        dense('%s_ffn_w1_{}' % part, D, F, (L,))
        dense('%s_ffn_w2_{}' % part, F, D, (L,))
        for j in range(2 if part == 'enc' else 3):
            out['params/%s_norm%d_a2' % (part, j + 1)] = ((L, D), 1.0, ns)
            out['params/%s_norm%d_b2' % (part, j + 1)] = ((L, D), 0.0, ns)
        out['params/%s_final_norm/a_2' % part] = ((D,), 1.0, ns)
        out['params/%s_final_norm/b_2' % part] = ((D,), 0.0, ns)
    out['params/tgt_embed'] = ((V1, D), 0.0, 1.0 / math.sqrt(D))
    dense('generator/{}', D, V1, gain=init['logit_gain'])
    return out


def position_table(n: int, D: int, device) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, D, 2, dtype=np.float64) * -(math.log(1e4) / D))
    pe = np.zeros((n, D))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.tensor(pe, dtype=torch.float32, device=device)


class Transformer:
    """The reference over ``W`` (``common.Weights``)."""

    def __init__(self, W, opt):
        self.W, self.opt = W, opt
        self.h = opt['num_att_heads']
        self.D = opt['d_model']

    def _p(self, name, i=None):
        t = self.W['params/' + name]
        return t if i is None else t[i]

    def _ffn(self, part, i, x):
        W = self.W
        y = torch.relu(W.linear(x, self._p('%s_ffn_w1_kernel' % part, i),
                                self._p('%s_ffn_w1_bias' % part, i)))
        return W.linear(y, self._p('%s_ffn_w2_kernel' % part, i),
                        self._p('%s_ffn_w2_bias' % part, i))

    def _ln(self, part, j, x, i=None):
        if i is None:
            return layer_norm(x, self._p('%s_final_norm/a_2' % part),
                              self._p('%s_final_norm/b_2' % part))
        return layer_norm(x, self._p('%s_norm%d_a2' % (part, j), i),
                          self._p('%s_norm%d_b2' % (part, j), i))

    def encode(self, att, att_masks=None):
        """The memory [B, M, D] of regions att [B, M, A]."""
        W = self.W
        x = torch.relu(W.linear(att.float(),
                                self._p('att_embed/Dense_0/kernel'),
                                self._p('att_embed/Dense_0/bias')))
        mask = None if att_masks is None else (att_masks > 0)[:, None, :]
        for i in range(self.opt['N_enc']):
            y = self._ln('enc', 1, x, i)
            x = x + self._attn('enc', 'self', i, y, y, mask)
            x = x + self._ffn('enc', i, self._ln('enc', 2, x, i))
        return self._ln('enc', None, x)

    def _attn(self, part, kind, i, x, mem, mask):
        W, h = self.W, self.h
        R, T, D = x.shape
        S = mem.shape[1]
        dk = D // h

        def proj(y, n):
            return W.linear(y, self._p('%s_%s_%s_kernel' % (part, kind, n),
                                       i),
                            self._p('%s_%s_%s_bias' % (part, kind, n), i))
        q = proj(x, 'wq').view(R, T, h, dk).transpose(1, 2)
        k = proj(mem, 'wk').view(R, S, h, dk).transpose(1, 2)
        v = proj(mem, 'wv').view(R, S, h, dk).transpose(1, 2)
        s = W.act(q) @ W.act(k).transpose(-1, -2) / math.sqrt(dk)
        if mask is not None:
            s = s.masked_fill(~mask[:, None], -1e9)
        ctx = W.act(torch.softmax(s, -1)) @ W.act(v)
        return proj(ctx.transpose(1, 2).reshape(R, T, D), 'wo')

    def logprobs(self, memory, tokens, att_masks=None, last=False):
        """Log-softmax [R, T, V+1] after each input position of tokens
        [R, T] (position 0 the bos 0), row r reading memory[r] [R, M,
        D]; with ``last`` only the last position's [R, 1, V+1]."""
        W, D = self.W, self.D
        R, T = tokens.shape
        emb = self._p('tgt_embed')
        x = emb[tokens] * math.sqrt(D)
        x = x + position_table(T, D, x.device)[None]
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                       device=x.device))[None]
        src = None if att_masks is None else (att_masks > 0)[:, None, :]
        for i in range(self.opt['N_dec']):
            y = self._ln('dec', 1, x, i)
            x = x + self._attn('dec', 'self', i, y, y, causal)
            x = x + self._attn('dec', 'src', i, self._ln('dec', 2, x, i),
                               memory, src)
            x = x + self._ffn('dec', i, self._ln('dec', 3, x, i))
        x = self._ln('dec', None, x[:, -1:] if last else x)
        logits = W.linear(x, self._p('generator/kernel'),
                          self._p('generator/bias'))
        return torch.log_softmax(logits, -1)

    # -- the decode protocol of ``decode.py`` ------------------------------
    def prepare(self, fc, att, att_masks=None):
        return self.encode(att, att_masks), att_masks

    def init_state(self, R, device):
        return None

    def step(self, prefix, feats, rows, state):
        """Log-softmax [R, V+1] after the last of the input tokens
        ``prefix`` [R, t + 1], recomputed over the whole prefix (no
        cache)."""
        memory, masks = feats
        return self.logprobs(memory[rows], prefix,
                             None if masks is None else masks[rows],
                             last=True)[:, -1], None

    def reorder(self, state, idx):
        return None

    def teacher_forced(self, feats, rows, tokens):
        memory, masks = feats
        return self.logprobs(memory[rows], tokens,
                             None if masks is None else masks[rows])

Model = Transformer
