"""FLOP model of the transformer captioner, and the shapes at which its
route launches the hand-written kernels.

Matrix-product FLOPs only (2 m n k), the useful work of the architecture:
``decode_step_flops`` is a frozen copy of
``captioning_tpu_torch/tools/bench.py:decode_step_flops`` (itself the
root ``bench.py``'s): per layer the self q/k/v/o projections (8 d^2),
the attend over the lane's own history (4 T d), the cross-attention's
projections (8 d^2) and its scores and context over the memory (4 M d),
the FFN (4 d f); plus the vocab logits (2 d V1).  Extended here by the
encoder.  LayerNorms, softmaxes, gathers and the
beam bookkeeping move bytes, not FLOPs, and are left out.
"""

from __future__ import annotations


def decode_step_flops(opt, n_mem: int, cache_len: int) -> float:
    """One decode step of one lane (frozen copy, see the module doc)."""
    d, f, L = opt['d_model'], opt['d_ff'], opt['N_dec']
    per_layer = (16.0 * d * d + 4.0 * cache_len * d + 4.0 * n_mem * d
                 + 4.0 * d * f)
    return L * per_layer + 2.0 * d * (opt['vocab_size'] + 1)


def encoder_flops(opt, n_mem: int) -> float:
    """The encoder over one image's n_mem regions: the att embed (2 M F d)
    and per layer the q/k/v/o projections (8 M d^2), scores and context
    (4 M^2 d) and the FFN (4 M d f)."""
    d, f = opt['d_model'], opt['d_ff']
    per_layer = 8.0 * n_mem * d * d + 4.0 * n_mem * n_mem * d \
        + 4.0 * n_mem * d * f
    return 2.0 * n_mem * opt['att_feat_size'] * d + opt['N_enc'] * per_layer


def beam_flops(opt, n_mem: int, B: int, bdash: int, graph: int) -> float:
    """The FLOPs one replay of graph ``graph`` of a beam decode of B
    images runs: graph 0 the setup (the encoder and the bos step of B
    rows), graph t + 1 the body of step t (the model step of the B x
    bdash lanes at position t, none at t = 0)."""
    if graph == 0:
        return B * (encoder_flops(opt, n_mem)
                    + decode_step_flops(opt, n_mem, 1))
    t = graph - 1
    return B * bdash * decode_step_flops(opt, n_mem, t + 1) if t else 0.0


def beam_launches(opt, n_mem: int, B: int, bdash: int, graph: int):
    """{kernel wrapper: its shape} of the hand-written kernels graph
    ``graph`` of the beam decode launches (``beam_flops``' numbering): B1
    (``attend_write_merged``) in each decoder layer of a model step and B2
    (``logit_topk``) after it; the setup's bos step at bw 1."""
    d, V1 = opt['d_model'], opt['vocab_size'] + 1
    h = opt['num_att_heads']
    if graph == 0:
        N, t0, bw = B, 0, 1
    elif graph == 1:
        return {}
    else:
        N, t0, bw = B * bdash, graph - 1, bdash
    return {'attend_write_merged': dict(N=N, D=d, h=h, bw=bw, t0=t0,
                                        dtype_bytes=2),
            'logit_topk': dict(N=N, D=d, V1=V1, k=bdash, dtype_bytes=2)}

