"""Model configuration (port of ``captioning_tpu/models/harness.py:35-126``).

Only the fields the ported models read are kept (the transformer, bert
and M2, the RNN attention harness, ShowTell and AoANet); the compute
dtype is a torch dtype.  ``use_pallas``
chooses, for CPU tensors only, which JAX branch the RNN attention head
mirrors (the fused kernel's twin or the plain jnp math); CUDA tensors
always take the CUDA kernels.  Its "auto" value (None / -1) resolves as
the JAX package resolves it off a TPU: 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    caption_model: str
    vocab_size: int
    input_encoding_size: int = 512
    rnn_size: int = 512
    num_layers: int = 1
    drop_prob_lm: float = 0.5
    seq_length: int = 20           # max sample length (max_length opt)
    fc_feat_size: int = 2048
    att_feat_size: int = 2048
    att_hid_size: int = 512
    logit_layers: int = 1
    use_bn: int = 0
    bos_idx: int = 0
    eos_idx: int = 0
    pad_idx: int = 0
    unk_idx: Optional[int] = None
    # transformer family (bert and m2transformer too)
    N_enc: int = 6
    N_dec: int = 6
    d_model: int = 512
    d_ff: int = 2048
    num_att_heads: int = 8
    dropout: float = 0.1
    # aoa
    refine: int = 1
    refine_aoa: int = 1
    use_ff: int = 0
    mean_feats: int = 1
    use_multi_head: int = 2
    multi_head_scale: int = 1
    ctx_drop: int = 1
    num_heads: int = 8
    dropout_aoa: float = 0.3
    decoder_type: str = 'AoA'
    out_res: int = 0
    # show_tell
    rnn_type: str = 'lstm'
    use_pallas: int = 0
    dtype: torch.dtype = torch.float32


def _resolve_use_pallas(flag) -> int:
    return 0 if flag is None or int(flag) < 0 else int(flag)


def config_from_opt(opt, vocab_size: int) -> ModelConfig:
    """Build a ModelConfig from an opts namespace / infos opt."""
    g = lambda k, d: getattr(opt, k, d)
    seq_length = g('max_length', 20) or g('seq_length', 20)
    return ModelConfig(
        caption_model=opt.caption_model,
        vocab_size=vocab_size,
        input_encoding_size=opt.input_encoding_size,
        rnn_size=opt.rnn_size,
        num_layers=opt.num_layers,
        drop_prob_lm=opt.drop_prob_lm,
        seq_length=seq_length,
        fc_feat_size=opt.fc_feat_size,
        att_feat_size=opt.att_feat_size,
        att_hid_size=opt.att_hid_size,
        logit_layers=g('logit_layers', 1),
        use_bn=g('use_bn', 0),
        bos_idx=g('bos_idx', 0), eos_idx=g('eos_idx', 0),
        pad_idx=g('pad_idx', 0), unk_idx=g('unk_idx', None),
        N_enc=g('N_enc', opt.num_layers), N_dec=g('N_dec', opt.num_layers),
        d_model=g('d_model', opt.input_encoding_size),
        d_ff=g('d_ff', opt.rnn_size),
        num_att_heads=g('num_att_heads', 8),
        dropout=g('dropout', 0.1),
        refine=g('refine', 1), refine_aoa=g('refine_aoa', 1),
        use_ff=g('use_ff', 0), mean_feats=g('mean_feats', 1),
        use_multi_head=g('use_multi_head', 2),
        multi_head_scale=g('multi_head_scale', 1),
        ctx_drop=g('ctx_drop', 1),
        num_heads=g('num_heads', 8),
        dropout_aoa=g('dropout_aoa', 0.3),
        decoder_type=g('decoder_type', 'AoA'),
        out_res=g('out_res', 0),
        rnn_type=g('rnn_type', 'lstm'),
        use_pallas=_resolve_use_pallas(g('use_pallas', None)),
        dtype=_DTYPES[g('compute_dtype', 'float32')],
    )
