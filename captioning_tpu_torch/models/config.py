"""Model configuration (port of ``captioning_tpu/models/harness.py:35-126``).

Only the fields the ported eval transformer reads are kept (no dropout:
there is no training yet); the compute dtype is a torch dtype.  Old infos
pickles carry ``use_pallas``: it is read by nothing here, because the port
always takes its CUDA kernel path for CUDA tensors and the plain PyTorch
twins for CPU tensors.
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
    seq_length: int = 20           # max sample length (max_length opt)
    att_feat_size: int = 2048
    use_bn: int = 0
    bos_idx: int = 0
    eos_idx: int = 0
    pad_idx: int = 0
    unk_idx: Optional[int] = None
    # transformer family
    N_enc: int = 6
    N_dec: int = 6
    d_model: int = 512
    d_ff: int = 2048
    num_att_heads: int = 8
    dtype: torch.dtype = torch.float32


def config_from_opt(opt, vocab_size: int) -> ModelConfig:
    """Build a ModelConfig from an opts namespace / infos opt."""
    g = lambda k, d: getattr(opt, k, d)
    seq_length = g('max_length', 20) or g('seq_length', 20)
    return ModelConfig(
        caption_model=opt.caption_model,
        vocab_size=vocab_size,
        seq_length=seq_length,
        att_feat_size=opt.att_feat_size,
        use_bn=g('use_bn', 0),
        bos_idx=g('bos_idx', 0), eos_idx=g('eos_idx', 0),
        pad_idx=g('pad_idx', 0), unk_idx=g('unk_idx', None),
        N_enc=g('N_enc', opt.num_layers), N_dec=g('N_dec', opt.num_layers),
        d_model=g('d_model', opt.input_encoding_size),
        d_ff=g('d_ff', opt.rnn_size),
        num_att_heads=g('num_att_heads', 8),
        dtype=_DTYPES[g('compute_dtype', 'float32')],
    )
