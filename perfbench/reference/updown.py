"""Plain float32 reference of UpDown (bottom-up top-down attention,
``configs/updown/updown.yml``; upstream ImageCaptioning.pytorch's
``UpDownModel`` with ``TopDownCore``).

* fc_embed, att_embed: Linear -> ReLU (to rnn_size); ctx2att: Linear
  (rnn_size -> att_hid_size) of the embedded regions;
* a step: the word embedding and a ReLU; the attention LSTM over
  [h_lang, fc_embed, word]; additive attention (h2att of h_att, tanh of
  its sum with ctx2att, alpha_net, softmax, renormalised by the region
  mask) over the embedded regions; the language LSTM over [attended,
  h_att]; the logit Linear of h_lang and a log-softmax.  LSTM cells as
  torch's (gates i, f, g, o; both biases).

Dropout is 0 here (the benchmark's configurations set it to 0).  The
weights are the checkpoint's (``model.npz`` names, kernels [in, out]).
"""

from __future__ import annotations

import math

import torch


def layout(opt, init):
    """{checkpoint name: (shape, mean, std)} of the weights the benchmark
    draws: kernels N(0, 1 / fan_in) (the logit's std times
    ``init['logit_gain']``), biases N(0, bias_std^2), the word embedding
    N(0, 1)."""
    E, H, A = opt['input_encoding_size'], opt['rnn_size'], opt['att_hid_size']
    F, V1 = opt['att_feat_size'], opt['vocab_size'] + 1
    bs = init['bias_std']
    out = {}

    def dense(name, fin, fout, gain=1.0):
        out['params/%s/kernel' % name] = ((fin, fout), 0.0,
                                          gain / math.sqrt(fin))
        out['params/%s/bias' % name] = ((fout,), 0.0, bs)

    out['params/embed/embedding'] = ((V1, E), 0.0, 1.0)
    dense('fc_embed/Dense_0', opt['fc_feat_size'], H)
    dense('att_embed/Dense_0', F, H)
    dense('ctx2att', H, A)
    dense('core/att_lstm/ih', 2 * H + E, 4 * H)
    dense('core/att_lstm/hh', H, 4 * H)
    dense('core/attention/h2att', H, A)
    dense('core/attention/alpha_net', A, 1)
    dense('core/lang_lstm/ih', 2 * H, 4 * H)
    dense('core/lang_lstm/hh', H, 4 * H)
    dense('logit', H, V1, gain=init['logit_gain'])
    return out


class UpDown:
    """The reference over ``W`` (``common.Weights``).  A state is (h, c),
    each [R, 2, H]: row 0 the attention LSTM, row 1 the language LSTM."""

    def __init__(self, W, opt):
        self.W, self.opt = W, opt
        self.H = opt['rnn_size']

    def _lin(self, name, x):
        return self.W.linear(x, self.W['params/%s/kernel' % name],
                             self.W['params/%s/bias' % name])

    def prepare(self, fc, att, att_masks=None):
        """(fc_embed [B, H], the embedded regions [B, M, H], their keys
        [B, M, A], the mask or None)."""
        p_fc = torch.relu(self._lin('fc_embed/Dense_0', fc.float()))
        x = torch.relu(self._lin('att_embed/Dense_0', att.float()))
        return p_fc, x, self._lin('ctx2att', x), att_masks

    def init_state(self, R, device):
        z = torch.zeros(R, 2, self.H, device=device)
        return z, z.clone()

    def _lstm(self, name, x, h, c):
        H = self.H
        s = self._lin('core/%s/ih' % name, x) + self._lin('core/%s/hh' % name,
                                                          h)
        i, f = torch.sigmoid(s[:, :H]), torch.sigmoid(s[:, H:2 * H])
        g, o = torch.tanh(s[:, 2 * H:3 * H]), torch.sigmoid(s[:, 3 * H:])
        c = f * c + i * g
        return o * torch.tanh(c), c

    def step(self, prefix, feats, rows, state):
        """Log-softmax [R, V+1] of one step and the next state: the last
        tokens of ``prefix`` [R, t + 1], row r reading image ``rows[r]``
        of ``feats`` (``prepare``)."""
        W = self.W
        it = prefix[:, -1]
        p_fc, att, p_att, masks = feats
        h, c = state
        xt = torch.relu(W['params/embed/embedding'][it])
        h_att, c_att = self._lstm(
            'att_lstm', torch.cat([h[:, 1], p_fc[rows], xt], 1), h[:, 0],
            c[:, 0])
        q = self._lin('core/attention/h2att', h_att)
        dot = torch.tanh(p_att[rows] + q[:, None])
        e = self._lin('core/attention/alpha_net', dot)[..., 0]
        w = torch.softmax(e, -1)
        if masks is not None:
            w = w * masks[rows]
            w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
        ctx = (W.act(w)[:, None] @ W.act(att[rows]))[:, 0]
        h_lang, c_lang = self._lstm('lang_lstm', torch.cat([ctx, h_att], 1),
                                    h[:, 1], c[:, 1])
        logits = self._lin('logit', h_lang)
        return (torch.log_softmax(logits, -1),
                (torch.stack([h_att, h_lang], 1),
                 torch.stack([c_att, c_lang], 1)))

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

Model = UpDown
