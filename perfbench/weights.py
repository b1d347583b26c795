"""Random weights from the seed, made on the device in one call.

A configuration's plain reference gives the checkpoint layout
(``layout(options, init)``: {``model.npz`` name: (shape, mean, std)}).
One ``torch.randn`` on the device, from a generator seeded with the run's
seed, fills one float32 buffer; each tensor is a view of it, scaled and
shifted in place.  The program loads the host copy through its
checkpoint path (``Captioner.load_jax_variables``); the reference reads
the device tensors.
"""

from __future__ import annotations

import math

import torch

from . import seeds


def make(layout, seed: int, device):
    """({name: float32 tensor on ``device``}, {name: numpy array}), both
    views of one buffer each."""
    names = sorted(layout)
    total = sum(math.prod(layout[n][0]) for n in names)
    g = torch.Generator(device).manual_seed(seeds.derive(seed, 'weights'))
    flat = torch.randn(total, generator=g, device=device)
    dev, at = {}, 0
    for n in names:
        shape, mean, std = layout[n]
        size = math.prod(shape)
        dev[n] = flat[at:at + size].view(shape).mul_(std).add_(mean)
        at += size
    host = flat.cpu().numpy()
    out, at = {}, 0
    for n in names:
        size = math.prod(layout[n][0])
        out[n] = host[at:at + size].reshape(layout[n][0])
        at += size
    return dev, out
