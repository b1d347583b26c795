"""Transformer captioner with a KV-cached single-step decode (eval).

Port of ``captioning_tpu/models/transformer.py``.  The math is the JAX
module's, line for line where it matters for parity:

* pre-LN sublayers with the reference LayerNorm flavour: the *unbiased*
  std, with eps added to the std rather than the variance;
* the encoder input is the att_embed output; embeddings are scaled by
  sqrt(d_model) (computed in the compute dtype) plus a sinusoidal PE;
* decode steps keep per-layer MERGED-LANE caches ``[N, Tp, D]`` with
  ``Tp = ceil((L + 1) / 8) * 8`` and attend through a beam-ancestry table
  (``state['anc']``): physical cache slots never move during beam search;
* decode-step cross-attention is the folded (lazy) form: ``W_k`` folds
  into the query, the K bias drops out of the softmax, ``b_v`` is added
  once after the weighted sum.

Parameters are float32 masters; ``install_compute_copies`` gives the matmul
weights and the token embedding their copies in ``cfg.dtype`` (the JAX
``Dense`` casts its float32 params at every use, LayerNorm params stay
float32; ``layers``).  The self-attention of
every decode step goes through ``ops.beam_attend.attend_write_merged`` (a
CUDA kernel for CUDA tensors, its plain twin for CPU tensors); the vocab
epilogue on ``step(return_hidden=True)`` is ``models.api``'s
``step_topk``.  A step at per-row positions (``uniform_t=False``: the
staggered groups of diverse decoding) goes the plain way, as the JAX
module takes it on every backend: each row's positional row, its K/V
written at its own slot, the ancestry attend masked per row
(``_attend_rows``).  A train-mode step at a uniform ``t`` (the RL
sampling pass and its recompute) runs the same layers with the cache
written at slot t by a select, as the JAX ``uniform_t`` branch writes it
by a dynamic slice: no host read, so a CUDA graph holds it.

``forward_tf`` and ``prepare_feature`` also run in train mode, given a
generator ``gen`` (None is eval): dropout at the JAX sites (the att embed
at ``drop_prob_lm``; at ``dropout`` the attention probabilities, each
residual branch, the feed-forward's inner activation and the embedding
plus positional encoding), drawn from ``gen``, and the BatchNorm's batch
statistics; so does the decode step (the recompute of
``engine.decoding.scan_logprobs``), with the attention dropout of the
folded cross-attention as the JAX module draws it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops.beam_attend import attend_write_merged, sqrt_in
from .config import ModelConfig
from .layers import (MaskedBatchNorm, MLPEmbed, compute_param, dropout,
                     install_compute_copies, linear, uniform_)

_NEG_INF = -1e9


def _pln(x, a_2, b_2, eps: float = 1e-6):
    """Reference LayerNorm: unbiased std, eps added to the std."""
    c = x.shape[-1]
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).pow(2).mean(-1, keepdim=True) * (c / max(c - 1, 1))
    y = a_2 * (x32 - mean) / (var.sqrt() + eps) + b_2
    return y.to(x.dtype)


class RefLayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(c))
        self.b_2 = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return _pln(x, self.a_2, self.b_2)


def _split_heads(x, h):
    # [..., T, D] -> [..., h, T, dk]
    *lead, T, D = x.shape
    return x.reshape(*lead, T, h, D // h).transpose(-2, -3)


def _merge_heads(x):
    # [..., h, T, dk] -> [..., T, D]
    x = x.transpose(-2, -3)
    *lead, T, h, dk = x.shape
    return x.reshape(*lead, T, h * dk)


def _softmax_f32(scores, dtype):
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def _attend(q, k, v, mask, p: float = 0.0, gen=None):
    """Scaled dot-product attention; mask broadcastable to the scores
    (1 = attend); the probabilities take dropout p in train mode."""
    scores = q @ k.transpose(-1, -2) / sqrt_in(q.shape[-1], q.dtype)
    if mask is not None:
        scores = scores.masked_fill(mask == 0, _NEG_INF)
    return dropout(_softmax_f32(scores, q.dtype), p, gen) @ v


def _attend_rows(q, k, v, anc, time_mask, bw: int, h: int, p: float = 0.0,
                 gen=None):
    """One decode step's self-attention over merged-lane caches, rows at
    their own positions (the JAX ``_attend_merged_eval``).

    q: [N, D]; k / v: [N, Tp, D]; time_mask: [N, Tp] (the valid past
    positions of each row); with ``bw``, ``anc`` [N, Tp] maps each row's
    past positions to the sibling slot (in its block of ``bw`` rows) that
    holds them: the scores run over every sibling slot and the ancestor's
    is selected by an exact mask.  Returns the merged-head contexts [N, D];
    the probabilities take dropout p in train mode."""
    N, T, D = k.shape
    dk = D // h
    scale = sqrt_in(dk, q.dtype)
    if bw:
        nb = N // bw
        q4 = q.reshape(nb, bw, h, dk)
        k5 = k.reshape(nb, bw, T, h, dk)
        v5 = v.reshape(nb, bw, T, h, dk)
        scores = torch.einsum('bqhd,bsthd->bqhst', q4, k5) / scale
        sel = torch.nn.functional.one_hot(anc.reshape(nb, bw, T).long(),
                                          bw).bool()           # [b,q,t,s]
        allowed = sel.transpose(-1, -2) & time_mask.reshape(nb, bw, 1, T)
        scores = scores.masked_fill(~allowed[:, :, None], _NEG_INF)
        pr = _softmax_f32(scores.reshape(nb, bw, h, bw * T), q.dtype)
        pr = dropout(pr, p, gen).reshape(nb, bw, h, bw, T)
        return torch.einsum('bqhst,bsthd->bqhd', pr, v5).reshape(N, D)
    scores = torch.einsum('bhd,bthd->bht', q.reshape(N, h, dk),
                          k.reshape(N, T, h, dk)) / scale
    scores = scores.masked_fill(~time_mask[:, None, :], _NEG_INF)
    pr = dropout(_softmax_f32(scores, q.dtype), p, gen)
    return torch.einsum('bht,bthd->bhd', pr,
                        v.reshape(N, T, h, dk)).reshape(N, D)


def _xavier_(w: torch.Tensor, fan_in: int, fan_out: int,
             generator: torch.Generator):
    uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), generator)


class _Lin(nn.Linear):
    """nn.Linear with the JAX transformer's init: xavier-uniform kernel,
    U(+-1/sqrt(fan_in)) bias."""

    def init_weights(self, generator: torch.Generator):
        _xavier_(self.weight, self.in_features, self.out_features, generator)
        uniform_(self.bias, 1.0 / math.sqrt(max(self.in_features, 1)),
                 generator)


class EncoderLayer(nn.Module):
    def __init__(self, D: int, F_: int):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (_Lin(D, D) for _ in range(4))
        self.w1, self.w2 = _Lin(D, F_), _Lin(F_, D)
        self.norm1, self.norm2 = RefLayerNorm(D), RefLayerNorm(D)

    def forward(self, x, mask, h: int, p: float = 0.0, gen=None):
        y = self.norm1(x)
        q = _split_heads(linear(y, self.wq), h)
        k = _split_heads(linear(y, self.wk), h)
        v = _split_heads(linear(y, self.wv), h)
        y = linear(_merge_heads(_attend(q, k, v, mask, p, gen)), self.wo)
        x = x + dropout(y, p, gen)
        y = linear(dropout(torch.relu(linear(self.norm2(x), self.w1)), p,
                           gen), self.w2)
        return x + dropout(y, p, gen)


class DecoderLayer(nn.Module):
    def __init__(self, D: int, F_: int):
        super().__init__()
        self.s_wq, self.s_wk, self.s_wv, self.s_wo = (
            _Lin(D, D) for _ in range(4))
        self.c_wq, self.c_wk, self.c_wv, self.c_wo = (
            _Lin(D, D) for _ in range(4))
        self.w1, self.w2 = _Lin(D, F_), _Lin(F_, D)
        self.norm1, self.norm2, self.norm3 = (RefLayerNorm(D)
                                              for _ in range(3))

    def lazy_cross(self, y, mem, att_masks, h: int, p: float = 0.0,
                   gen=None):
        """Decode-step cross-attention over the raw encoder memory, with
        the K/V projections folded around the attention.

        y: [B, D] with B = nb * bw (bw lanes of a beam block share one
        memory row); mem: [nb, M, D]; att_masks: [nb, M] or None.  In train
        mode the probabilities take dropout p, and the folded V bias is
        weighted by their dropped sums, as the JAX module computes it."""
        B, D = y.shape
        dk = D // h
        nb = mem.shape[0]
        bw = B // nb
        q = linear(y, self.c_wq).view(B, h, dk)
        wk = compute_param(self.c_wk, 'weight').to(mem.dtype).view(h, dk, D)
        qt = torch.einsum('bhk,hkd->bhd', q, wk)
        scores = (qt.reshape(nb, bw * h, D) @ mem.transpose(1, 2)
                  / sqrt_in(dk, q.dtype))
        if att_masks is not None:
            scores = scores.masked_fill(att_masks[:, None, :] == 0, _NEG_INF)
        pr = dropout(_softmax_f32(scores, q.dtype), p, gen)
        ctx = pr @ mem                                      # [nb, bw*h, D]
        wv = compute_param(self.c_wv, 'weight').to(mem.dtype).view(h, dk, D)
        out = torch.einsum('bhd,hkd->bhk', ctx.reshape(B, h, D), wv)
        bv = compute_param(self.c_wv, 'bias').to(mem.dtype).view(1, h, dk)
        if gen is not None and p > 0:
            out = out + bv * pr.sum(-1).reshape(B, h, 1)
        else:
            out = out + bv
        return linear(out.reshape(B, D), self.c_wo)


class TransformerCaptioner(nn.Module):
    """Encoder-decoder captioner exposing the engine step protocol."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        D, F_ = cfg.d_model, cfg.d_ff
        self.att_bn_in = MaskedBatchNorm(cfg.att_feat_size) \
            if cfg.use_bn else None
        self.att_embed = MLPEmbed(cfg.att_feat_size, D, cfg.drop_prob_lm)
        self.att_bn_out = MaskedBatchNorm(D) if cfg.use_bn == 2 else None
        self.enc = nn.ModuleList(EncoderLayer(D, F_)
                                 for _ in range(cfg.N_enc))
        self.enc_final_norm = RefLayerNorm(D)
        self.dec = nn.ModuleList(DecoderLayer(D, F_)
                                 for _ in range(cfg.N_dec))
        self.dec_final_norm = RefLayerNorm(D)
        V1 = cfg.vocab_size + 1
        self.tgt_embed = nn.Parameter(torch.zeros(V1, D))
        self.generator = _Lin(D, V1)
        # sinusoidal PE table, float32 as the JAX module builds it
        max_len = max(cfg.seq_length + 4, 64)
        pe = np.zeros((max_len, D), np.float32)
        position = np.arange(0, max_len)[:, None].astype(np.float32)
        div_term = np.exp(np.arange(0, D, 2).astype(np.float32) *
                          -(np.log(10000.0) / D))
        pe[:, 0::2] = np.sin(position * div_term)
        pe[:, 1::2] = np.cos(position * div_term)
        self.register_buffer('pe', torch.from_numpy(pe), persistent=False)

    # -- parameters ----------------------------------------------------------
    def init_weights(self, generator: torch.Generator):
        """The JAX module's init, drawn from ``generator`` (the two
        frameworks' streams differ; parity tests load JAX weights)."""
        self.att_embed.init_weights(generator)
        for m in self.modules():
            if isinstance(m, _Lin):
                m.init_weights(generator)
        V1, D = self.tgt_embed.shape
        _xavier_(self.tgt_embed, D, V1, generator)
        return self

    def install_compute_copies(self):
        """The (master, copy) pairs of the matmul weights and the token
        embedding in ``cfg.dtype`` (``layers.install_compute_copies``)."""
        return install_compute_copies(self, self.cfg.dtype, nn.Linear,
                                      extra=('tgt_embed',))

    def _embed(self, ids):
        """The token embedding, cast then gathered (the JAX ``jnp.take`` of
        ``tgt_embed.astype(dtype)``), scaled by sqrt(d_model)."""
        dt = self.cfg.dtype
        return (compute_param(self, 'tgt_embed')[ids].to(dt)
                * sqrt_in(self.cfg.d_model, dt))

    # -- encoder -------------------------------------------------------------
    def encode(self, att_feats, att_masks, gen=None):
        train = gen is not None
        x = att_feats
        if self.att_bn_in is not None:
            x = self.att_bn_in(x, att_masks, train)
        x = self.att_embed(x, gen)
        if self.att_bn_out is not None:
            x = self.att_bn_out(x, att_masks, train)
        mask = None if att_masks is None else att_masks[:, None, None, :]
        for layer in self.enc:
            x = layer(x, mask, self.cfg.num_att_heads, self.cfg.dropout, gen)
        return self.enc_final_norm(x)

    def prepare_feature(self, fc_feats, att_feats, att_masks, gen=None):
        # decode steps attend the raw memory with the K/V projections folded
        # around the attention (DecoderLayer.lazy_cross)
        return {'memory': self.encode(att_feats, att_masks, gen),
                'att_masks': att_masks}

    def init_state(self, batch_size: int, beam: bool = False) -> Dict:
        """Per-layer merged-lane caches [N, Tp, D] and the step ``t`` as a
        Python int (the host decode loop owns it; a per-row step makes it a
        [N] tensor).  ``beam`` (single-group beam search) is the JAX
        module's layout hint: one layout serves every route here."""
        cfg = self.cfg
        Tp = -(-(cfg.seq_length + 1) // 8) * 8
        dev = self.pe.device
        state = {'t': 0}
        for i in range(cfg.N_dec):
            for kv in 'kv':
                state['%s%d' % (kv, i)] = torch.zeros(
                    batch_size, Tp, cfg.d_model, dtype=cfg.dtype, device=dev)
        return state

    # -- decode step -----------------------------------------------------------
    def step(self, it, feats, state, logsoftmax: bool = True,
             uniform_t: bool = True, beam_width: int = 0,
             return_hidden: bool = False, gen=None):
        """One cached decoder step at the uniform position ``state['t']``.

        The per-layer caches (and ``state['anc']``) are updated IN PLACE;
        the returned state is a new dict over the same buffers with t + 1.
        ``beam_width > 0`` attends through ``state['anc']`` (rows grouped
        in blocks of ``beam_width`` physical slots); 0 is plain decoding.
        Train mode (``gen``, dropout drawn from it) at a uniform host-int
        ``t`` takes ``_step_train``; rows at their own ``t``
        (``uniform_t=False``, or a [N] ``t``) take ``_step_rows``.
        """
        if (gen is not None and uniform_t and not beam_width
                and not torch.is_tensor(state['t'])):
            return self._step_train(it, feats, state, logsoftmax,
                                    return_hidden, gen)
        if gen is not None or not uniform_t:
            return self._step_rows(it, feats, state, logsoftmax, beam_width,
                                   return_hidden, gen)
        cfg = self.cfg
        h, dt, D = cfg.num_att_heads, cfg.dtype, cfg.d_model
        t0 = int(state['t'])
        B = it.shape[0]
        x = self._embed(it)
        x = x + self.pe[t0].to(dt)

        new_state = dict(state, t=t0 + 1)
        mem, am = feats['memory'], feats['att_masks']
        anc, bw = None, 1
        if beam_width:
            anc, bw = state['anc'], beam_width
            # this step's entry lives in the row's own slot
            anc[:, t0] = torch.arange(B, device=anc.device,
                                      dtype=anc.dtype) % beam_width
        for i, layer in enumerate(self.dec):
            y = layer.norm1(x)
            ctx = attend_write_merged(
                linear(y, layer.s_wq), state['k%d' % i], state['v%d' % i],
                linear(y, layer.s_wk), linear(y, layer.s_wv), anc, t0,
                bw=bw, h=h)
            x = x + linear(ctx, layer.s_wo)
            x = x + layer.lazy_cross(layer.norm2(x), mem, am, h)
            x = x + linear(torch.relu(linear(layer.norm3(x), layer.w1)),
                           layer.w2)
        return self._logits(x, new_state, logsoftmax, return_hidden)

    def _logits(self, x, state, logsoftmax: bool, return_hidden: bool):
        x = self.dec_final_norm(x)
        if return_hidden:
            return x, state
        logits = linear(x, self.generator).float()
        if logsoftmax:
            return torch.log_softmax(logits, dim=-1), state
        return logits, state

    def _step_train(self, it, feats, state, logsoftmax: bool,
                    return_hidden: bool, gen):
        """The train-mode step at the uniform host-int ``state['t']`` (the
        JAX ``uniform_t`` branch): position t of each layer's cache is
        written out of place by a select over a one-hot of t, a fixed
        sequence of kernels that reads nothing on the host.  Its dropout
        sites and their order are ``_step_rows``'s (``_layer_rows``), so the
        same generator state draws the same masks and the logprobs are
        ``_step_rows``'s."""
        cfg = self.cfg
        dt, D, p = cfg.dtype, cfg.d_model, cfg.dropout
        B = it.shape[0]
        Tp = state['k0'].shape[1]
        t = int(state['t'])
        x = self._embed(it)
        x = dropout(x + self.pe[min(t, self.pe.shape[0] - 1)].to(dt), p, gen)
        new_state = dict(state, t=t + 1)
        pos = torch.arange(Tp, device=it.device)
        at_t = (pos == t)[None, :, None]
        time_mask = (pos <= t)[None].expand(B, Tp)

        def write(kc, new):
            return torch.where(at_t, new[:, None], kc)

        for i, layer in enumerate(self.dec):
            x, new_state['k%d' % i], new_state['v%d' % i] = self._layer_rows(
                layer, x, state['k%d' % i], state['v%d' % i], write, None,
                time_mask, 0, feats, gen)
        return self._logits(x, new_state, logsoftmax, return_hidden)

    def _layer_rows(self, layer, x, kc, vc, write, anc, time_mask,
                    beam_width: int, feats, gen):
        """One decoder layer of the plain step: K/V written by
        ``write(cache, new)`` (in place or out of place; returns the cache
        to attend), the self-attention masked per row, the folded
        cross-attention, the feed-forward.  Returns (x, k cache, v
        cache)."""
        cfg = self.cfg
        h, p = cfg.num_att_heads, cfg.dropout
        y = layer.norm1(x)
        kc = write(kc, linear(y, layer.s_wk))
        vc = write(vc, linear(y, layer.s_wv))
        ctx = _attend_rows(linear(y, layer.s_wq), kc, vc, anc, time_mask,
                           beam_width, h, p, gen)
        x = x + dropout(linear(ctx, layer.s_wo), p, gen)
        x = x + dropout(layer.lazy_cross(layer.norm2(x), feats['memory'],
                                         feats['att_masks'], h, p, gen),
                        p, gen)
        x = x + dropout(linear(dropout(torch.relu(
            linear(layer.norm3(x), layer.w1)), p, gen), layer.w2), p, gen)
        return x, kc, vc

    def _step_rows(self, it, feats, state, logsoftmax: bool,
                   beam_width: int, return_hidden: bool, gen=None):
        """The plain step: each row at its own ``state['t']`` (an int or a
        [N] tensor), in eval or in train mode (``gen``).  Eval writes the
        caches in place; train writes new ones (the returned state holds
        them), so the graph keeps every step's entries.  A row past the
        cache (a diverse group frozen after its finish) writes nothing,
        as the JAX scatter drops an update out of bounds."""
        cfg = self.cfg
        dt, D, p = cfg.dtype, cfg.d_model, cfg.dropout
        B = it.shape[0]
        Tp = state['k0'].shape[1]
        t = state['t']
        t_rows = (t if torch.is_tensor(t) else
                  torch.full((B,), t, dtype=torch.long, device=it.device))
        x = self._embed(it)
        x = x + self.pe[t_rows.clamp(max=self.pe.shape[0] - 1)].to(dt)
        x = dropout(x, p, gen)
        new_state = dict(state, t=t_rows + 1)
        ok = t_rows < Tp
        rows = torch.arange(B, device=it.device)[ok]
        slots = t_rows[ok]
        time_mask = (torch.arange(Tp, device=it.device)[None]
                     <= t_rows[:, None])
        anc = None
        if beam_width:
            # this step's entry lives in the row's own slot
            anc = state['anc'].index_put(
                (rows, slots), (rows % beam_width).to(state['anc'].dtype))
            new_state['anc'] = anc

        def write(kc, new):
            if gen is None:
                return kc.index_put_((rows, slots), new[ok])
            return kc.index_put((rows, slots), new[ok])

        for i, layer in enumerate(self.dec):
            x, kc, vc = self._layer_rows(
                layer, x, state['k%d' % i], state['v%d' % i], write, anc,
                time_mask, beam_width, feats, gen)
            if gen is not None:
                new_state['k%d' % i], new_state['v%d' % i] = kc, vc
        return self._logits(x, new_state, logsoftmax, return_hidden)

    # -- teacher forcing ---------------------------------------------------------
    def forward_tf(self, fc_feats, att_feats, seq, att_masks, gen=None,
                   ss_prob: float = 0.0):
        """Teacher-forced log-probs [N, T, V+1] over input tokens ``seq``
        (the reference _forward with its seq_mask semantics), in train mode
        given ``gen``.  ``ss_prob`` is unused: the JAX transformer takes no
        scheduled sampling either."""
        cfg = self.cfg
        h, dt, p = cfg.num_att_heads, cfg.dtype, cfg.dropout
        if seq.dim() == 3:
            seq = seq.reshape(-1, seq.shape[2])
        memory = self.encode(att_feats, att_masks, gen)
        nb = memory.shape[0]
        s = seq.shape[0] // nb        # seq_per_img rows share one memory row
        T = seq.shape[1]
        seq_mask = (seq != cfg.eos_idx) & (seq != cfg.pad_idx)
        seq_mask[:, 0] = True
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                       device=seq.device))
        tgt_mask = seq_mask[:, None, None, :] & causal[None, None]
        src_mask = (None if att_masks is None
                    else att_masks[:, None, None, None, :])

        x = self._embed(seq)
        x = dropout(x + self.pe[:T][None].to(dt), p, gen)
        for layer in self.dec:
            y = layer.norm1(x)
            q = _split_heads(linear(y, layer.s_wq), h)
            k = _split_heads(linear(y, layer.s_wk), h)
            v = _split_heads(linear(y, layer.s_wv), h)
            y = linear(_merge_heads(_attend(q, k, v, tgt_mask, p, gen)),
                       layer.s_wo)
            x = x + dropout(y, p, gen)
            y = layer.norm2(x)
            q2 = _split_heads(linear(y, layer.c_wq), h)
            mk = _split_heads(linear(memory, layer.c_wk), h)[:, None]
            mv = _split_heads(linear(memory, layer.c_wv), h)[:, None]
            q2 = q2.reshape(nb, s, *q2.shape[1:])
            ctx = _attend(q2, mk, mv, src_mask, p, gen).reshape(nb * s, h, T,
                                                                 -1)
            x = x + dropout(linear(_merge_heads(ctx), layer.c_wo), p, gen)
            y = linear(dropout(torch.relu(linear(layer.norm3(x), layer.w1)),
                               p, gen), layer.w2)
            x = x + dropout(y, p, gen)
        x = self.dec_final_norm(x)
        return torch.log_softmax(linear(x, self.generator).float(), dim=-1)

