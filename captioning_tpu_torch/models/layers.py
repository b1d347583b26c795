"""Shared building blocks (port of ``captioning_tpu/models/layers.py:21-143``).

Init semantics follow the JAX package, which follows torch's defaults:
``Dense`` kernels and biases are U(+-1/sqrt(fan_in)).  Parameters are
float32; a Linear computes in the dtype its weight was cast to
(``TransformerCaptioner.to_compute_dtype``), as the JAX ``Dense`` casts
its float32 params to the compute dtype at every use.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def init_dense(lin: nn.Linear, generator: torch.Generator):
    """``layers.Dense`` default init: kernel and bias U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(max(lin.in_features, 1))
    uniform_(lin.weight, bound, generator)
    if lin.bias is not None:
        uniform_(lin.bias, bound, generator)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``layers.Dense`` compute: the input is cast to the weight's dtype."""
    return F.linear(x.to(lin.weight.dtype), lin.weight, lin.bias)


class MLPEmbed(nn.Module):
    """Linear -> ReLU (-> Dropout, identity at eval); the att_embed pattern
    (reference AttModel.py:74-85)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)

    def init_weights(self, generator: torch.Generator):
        init_dense(self.Dense_0, generator)

    def forward(self, x):
        return torch.relu(linear(x, self.Dense_0))


class MaskedBatchNorm(nn.Module):
    """Eval branch of the masked BatchNorm1d over att features (use_bn):
    normalise with the running statistics."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('mean', torch.zeros(c))
        self.register_buffer('var', torch.ones(c))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        y = (x - self.mean) * torch.rsqrt(self.var + self.eps)
        return y * self.scale + self.bias
