"""Plain float32 reference of AoANet (Huang et al., "Attention on Attention
for Image Captioning", ICCV 2019; ``configs/aoa.yml``: upstream
ImageCaptioning.pytorch's ``AoAModel`` with ``refine`` 1, ``refine_aoa``
1, ``use_ff`` 0, ``decoder_type`` AoA, ``use_multi_head`` 2,
``multi_head_scale`` 1, ``mean_feats`` 1, ``ctx_drop`` 1).

* att_embed: Linear (att_feat_size -> rnn_size), ReLU;
* the refiner, 6 layers of ``x + AoA(MHA(LN(x)))`` and a final LayerNorm:
  q, k and v projections of the normed regions, 8-head scaled dot
  attention, then the AoA gate, a GLU over [attended; normed query]
  (Linear 2D -> 2D: its first half times the sigmoid of its second);
* the mean of the refined regions (the fc feature), and ``ctx2att``
  (Linear D -> 2D) of the refined regions: its first half the decoder
  attention's values, its second half its keys, as upstream's
  ``p_att_feats.narrow`` calls read them;
* a step: the word embedding and a ReLU; the attention LSTM over [word;
  mean regions + the previous context]; the decoder attention: a
  LayerNorm and the q projection of h_att, 8-head scaled dot attention
  over the keys and values of ``ctx2att``; the AoA output, a GLU of
  ``att2ctx`` (Linear 2D -> 2D) over [attended; h_att], which is the
  context the next step reads; the logit Linear and a log-softmax.  LSTM
  cells as torch's (gates i, f, g, o; both biases).  The LayerNorm is
  the model family's (unbiased std, eps on the std).

Departures from upstream: dropout is 0 (eval); a mask is applied as a
fill of -1e9 (upstream fills -inf; the same softmax where any region is
valid), and with masks None every region is attended and averaged, as
upstream does without masks.  The weights are the checkpoint's
(``model.npz`` names, kernels [in, out]).  Every matrix product and
every attention operand goes through ``Weights.linear`` /
``Weights.act``, so the float8 control rounds all of them.
"""

from __future__ import annotations

import math

import torch

from .common import layer_norm

# upstream AoA_Refiner_Core's depth
REFINER_LAYERS = 6


def layout(opt, init):
    """{checkpoint name: (shape, mean, std)} of the weights the benchmark
    draws: kernels N(0, 1 / fan_in) (the logit's std times
    ``init['logit_gain']``), biases N(0, bias_std^2), LayerNorm gains
    N(1, norm_std^2) and shifts N(0, norm_std^2), the word embedding
    N(0, 1)."""
    E, D = opt['input_encoding_size'], opt['rnn_size']
    F, V1 = opt['att_feat_size'], opt['vocab_size'] + 1
    bs, ns = init['bias_std'], init['norm_std']
    out = {}

    def dense(name, fin, fout, gain=1.0):
        out['params/%s/kernel' % name] = ((fin, fout), 0.0,
                                          gain / math.sqrt(fin))
        out['params/%s/bias' % name] = ((fout,), 0.0, bs)

    def norm(name):
        out['params/%s/a_2' % name] = ((D,), 1.0, ns)
        out['params/%s/b_2' % name] = ((D,), 0.0, ns)

    out['params/embed/embedding'] = ((V1, E), 0.0, 1.0)
    dense('att_embed/Dense_0', F, D)
    for i in range(REFINER_LAYERS):
        norm('refiner/norm1_%d' % i)
        for p in ('q', 'k', 'v'):
            dense('refiner/attn_%d/%s' % (i, p), D, D)
        dense('refiner/attn_%d/aoa' % i, 2 * D, 2 * D)
    norm('refiner/norm_out')
    dense('ctx2att', D, 2 * D)
    dense('att_lstm/ih', E + D, 4 * D)
    dense('att_lstm/hh', D, 4 * D)
    norm('attention/norm')
    dense('attention/q', D, D)
    dense('att2ctx', 2 * D, 2 * D)
    dense('logit', D, V1, gain=init['logit_gain'])
    return out


class AoA:
    """The reference over ``W`` (``common.Weights``).  A state is (h, c),
    each [R, 2, D]: row 0 the attention LSTM's, row 1 the context (h) and
    zeros (c)."""

    def __init__(self, W, opt):
        self.W, self.opt = W, opt
        self.D = opt['rnn_size']
        self.h = opt['num_heads']

    def _lin(self, name, x):
        return self.W.linear(x, self.W['params/%s/kernel' % name],
                             self.W['params/%s/bias' % name])

    def _ln(self, name, x):
        return layer_norm(x, self.W['params/%s/a_2' % name],
                          self.W['params/%s/b_2' % name])

    def _heads(self, x):
        """[R, T, D] -> [R, h, T, dk]."""
        R, T, D = x.shape
        return x.view(R, T, self.h, D // self.h).transpose(1, 2)

    def _attend(self, q, k, v, masks):
        """Scaled dot attention of q [R, T, D] over k, v [R, M, D], masks
        [R, M] or None: [R, T, D]."""
        W = self.W
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        s = W.act(q) @ W.act(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
        if masks is not None:
            s = s.masked_fill(masks[:, None, None, :] == 0, -1e9)
        ctx = W.act(torch.softmax(s, -1)) @ W.act(v)
        R, _, T, _ = ctx.shape
        return ctx.transpose(1, 2).reshape(R, T, self.D)

    @staticmethod
    def _glu(g):
        D = g.shape[-1] // 2
        return g[..., :D] * torch.sigmoid(g[..., D:])

    def refine(self, x, masks=None):
        """The refiner over embedded regions x [B, M, D]."""
        for i in range(REFINER_LAYERS):
            y = self._ln('refiner/norm1_%d' % i, x)
            a = 'refiner/attn_%d/' % i
            ctx = self._attend(self._lin(a + 'q', y), self._lin(a + 'k', y),
                               self._lin(a + 'v', y), masks)
            x = x + self._glu(self._lin(a + 'aoa', torch.cat([ctx, y], -1)))
        return self._ln('refiner/norm_out', x)

    def _lstm(self, name, x, h, c):
        D = self.D
        s = self._lin('%s/ih' % name, x) + self._lin('%s/hh' % name, h)
        i, f = torch.sigmoid(s[:, :D]), torch.sigmoid(s[:, D:2 * D])
        g, o = torch.tanh(s[:, 2 * D:3 * D]), torch.sigmoid(s[:, 3 * D:])
        c = f * c + i * g
        return o * torch.tanh(c), c

    # -- the decode protocol of ``decode.py`` ------------------------------
    def prepare(self, fc, att, att_masks=None):
        """(the mean of the refined regions [B, D], the refined regions
        [B, M, D], their ``ctx2att`` [B, M, 2D], the mask or None); the
        fc feature is not read (``mean_feats``)."""
        x = torch.relu(self._lin('att_embed/Dense_0', att.float()))
        x = self.refine(x, att_masks)
        if att_masks is None:
            mean = x.mean(1)
        else:
            m = att_masks[..., None].float()
            mean = (x * m).sum(1) / m.sum(1)
        return mean, x, self._lin('ctx2att', x), att_masks

    def init_state(self, R, device):
        z = torch.zeros(R, 2, self.D, device=device)
        return z, z.clone()

    def step(self, prefix, feats, rows, state):
        """Log-softmax [R, V+1] of one step and the next state: the last
        tokens of ``prefix`` [R, t + 1], row r reading image ``rows[r]``
        of ``feats`` (``prepare``)."""
        W, D = self.W, self.D
        it = prefix[:, -1]
        mean, _, p_att, masks = feats
        h, c = state
        xt = torch.relu(W['params/embed/embedding'][it])
        h_att, c_att = self._lstm(
            'att_lstm', torch.cat([xt, mean[rows] + h[:, 1]], 1), h[:, 0],
            c[:, 0])
        q = self._lin('attention/q', self._ln('attention/norm', h_att))
        pa = p_att[rows]
        value, key = pa[..., :D], pa[..., D:]
        att = self._attend(q[:, None], key, value,
                           None if masks is None else masks[rows])[:, 0]
        ctx = self._glu(self._lin('att2ctx', torch.cat([att, h_att], 1)))
        logits = self._lin('logit', ctx)
        return (torch.log_softmax(logits, -1),
                (torch.stack([h_att, ctx], 1),
                 torch.stack([c_att, c[:, 1]], 1)))

    def reorder(self, state, idx):
        return tuple(s.index_select(0, idx) for s in state)

    def teacher_forced(self, feats, rows, tokens):
        """Log-softmax [R, T, V+1] after each input position of tokens
        [R, T] (position 0 the bos 0)."""
        R, T = tokens.shape
        state = self.init_state(R, tokens.device)
        out = []
        for t in range(T):
            lp, state = self.step(tokens[:, :t + 1], feats, rows, state)
            out.append(lp)
        return torch.stack(out, 1)

Model = AoA
