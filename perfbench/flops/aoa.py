"""FLOP model of AoANet, and the shapes at which its route launches the
hand-written kernels.

Matrix-product FLOPs only (2 m n k), as ``flops/updown.py`` counts them;
LayerNorms, softmaxes, the GLU's product and the beam bookkeeping move
bytes, not FLOPs, and are left out.  Preparing an image runs att_embed
(M F D), then per refiner layer the q / k / v projections (3 M D^2 at
``multi_head_scale`` 1), the scores and the context over the M regions
(2 M^2 D) and the AoA gate's Linear of [attended; query] to 2D (4 M D^2),
then ``ctx2att`` (M D 2D).  A step of one lane runs the attention LSTM
(its input [word; mean + context] of E + D and its hidden D, four gates
of D), the decoder attention's query projection (D^2), its scores and
context over the M regions (2 M D), ``att2ctx`` (2D x 2D) and the logit
(D V1).
"""

from __future__ import annotations

from perfbench.reference.aoa import REFINER_LAYERS


def step_flops(opt, n_mem: int) -> float:
    E, D = opt['input_encoding_size'], opt['rnn_size']
    V1 = opt['vocab_size'] + 1
    att_lstm = 2.0 * (E + D) * 4 * D + 2.0 * D * 4 * D
    attention = 2.0 * D * D + 2.0 * 2 * n_mem * D
    att2ctx = 2.0 * (2 * D) * (2 * D)
    return att_lstm + attention + att2ctx + 2.0 * D * V1


def prepare_flops(opt, n_mem: int) -> float:
    D, M = opt['rnn_size'], n_mem
    layer = (2.0 * 3 * M * D * D + 2.0 * 2 * M * M * D
             + 2.0 * M * (2 * D) * (2 * D))
    return (2.0 * M * opt['att_feat_size'] * D + REFINER_LAYERS * layer
            + 2.0 * M * D * (2 * D))


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
    ``graph`` of the beam decode launches: B6 (``topk_lastdim``) over the
    [B, bdash (V + 1)] candidate table in every body; the setup none (the
    dot attention is plain PyTorch)."""
    if graph == 0:
        return {}
    return {'topk_lastdim': dict(B=B, C=bdash * (opt['vocab_size'] + 1),
                                 k=bdash)}
