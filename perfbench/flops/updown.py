"""FLOP model of UpDown, and the shapes at which its route launches the
hand-written kernels.

Matrix-product FLOPs only (2 m n k), as ``flops/transformer.py`` counts
them: a step of one lane runs the attention LSTM (its input [h_lang,
fc, word] of 2H + E and its hidden H, four gates of H), h2att (H x A),
the attention's scores over the M regions (M A) and its context (M H),
the language LSTM (input 2H, hidden H) and the logit (H x V1); preparing
an image runs fc_embed (F H), att_embed (M F H) and ctx2att (M H A).
"""

from __future__ import annotations


def step_flops(opt, n_mem: int) -> float:
    E, H, A = opt['input_encoding_size'], opt['rnn_size'], opt['att_hid_size']
    V1 = opt['vocab_size'] + 1
    att_lstm = 2.0 * (2 * H + E) * 4 * H + 2.0 * H * 4 * H
    attention = 2.0 * H * A + 2.0 * n_mem * A + 2.0 * n_mem * H
    lang_lstm = 2.0 * (2 * H) * 4 * H + 2.0 * H * 4 * H
    return att_lstm + attention + lang_lstm + 2.0 * H * V1


def prepare_flops(opt, n_mem: int) -> float:
    H, A = opt['rnn_size'], opt['att_hid_size']
    return (2.0 * opt['fc_feat_size'] * H
            + 2.0 * n_mem * opt['att_feat_size'] * H
            + 2.0 * n_mem * H * A)


def beam_flops(opt, n_mem: int, B: int, bdash: int, graph: int) -> float:
    """The FLOPs one replay of graph ``graph`` of a beam decode of B
    images runs: graph 0 the setup (B images prepared, the bos step of B
    rows), graph t + 1 the body of step t (the step of B x bdash lanes,
    none at t = 0)."""
    if graph == 0:
        return B * (prepare_flops(opt, n_mem) + step_flops(opt, n_mem))
    return B * bdash * step_flops(opt, n_mem) if graph > 1 else 0.0


def beam_launches(opt, n_mem: int, B: int, bdash: int, graph: int):
    """{kernel wrapper: its shape} of the hand-written kernels graph
    ``graph`` of the beam decode launches: B3 (``additive_attention_fused``)
    in each model step (the bos step's one query row an image, then bdash
    lanes sharing an image's regions), B6 (``topk_lastdim``) over the
    [B, bdash (V + 1)] candidate table in every body."""
    H, A, V1 = opt['rnn_size'], opt['att_hid_size'], opt['vocab_size'] + 1
    att = dict(nb=B, M=n_mem, H=H, A=A, dtype_bytes=2)
    if graph == 0:
        return {'additive_attention_fused': dict(att, bw=1)}
    out = {'topk_lastdim': dict(B=B, C=bdash * V1, k=bdash)}
    if graph > 1:
        out['additive_attention_fused'] = dict(att, bw=bdash)
    return out

