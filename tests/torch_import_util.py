"""A synthetic upstream (``ruotianluo/ImageCaptioning.pytorch``)
``state_dict`` for a ``caption_model`` key, by inverting a converter
(``utils/torch_convert.convert_state_dict`` of either package): no JAX
here, so ``chip_smoke.py`` builds its full-width one with the port's
converter.

Every name the converter reads is found by running it on a growing dict
(a missing name raises ``KeyError``; a ``Linear`` bias it reads only when
present is added where the wanted tree has one), each name tagged with its
index, so that the converted tree shows which leaf (and which layer of a
stacked one) each name lands in.  Each name then takes that leaf of the
wanted tree, transposed where the leaf is a ``kernel`` (the converter
transposes every Linear / LSTM weight and nothing else)."""

import numpy as np
import torch


def _names(convert, cfg, want, flatten):
    """{upstream name: (leaf path, layer or None)} of every name the
    converter reads for ``cfg``; ``want`` is the wanted flat tree."""
    tags = {}
    while True:
        sd = {k: np.full((1, 1), i, np.float32)
              for i, k in enumerate(tags)}
        try:
            got = flatten(convert(sd, cfg))
        except KeyError as e:
            tags[e.args[0]] = None
            continue
        # a Linear's bias is read only where present
        missing = [p for p in want if p not in got
                   and p.endswith('/bias') and p[:-4] + 'kernel' in got]
        if not missing:
            break
        names = list(tags)
        for p in missing:
            weight = names[int(got[p[:-4] + 'kernel'].ravel()[0])]
            assert weight.endswith('.weight'), (p, weight)
            tags[weight[:-len('weight')] + 'bias'] = None
    names = list(tags)
    out = {}
    for path, v in got.items():
        ids = [int(x) for x in v.ravel()]
        stacked = v.ndim == 3
        for layer, i in enumerate(ids):
            out[names[i]] = (path, layer if stacked else None)
    assert sorted(out) == sorted(names)
    return out


def upstream_state_dict(convert, cfg, want, flatten):
    """The upstream state_dict (torch tensors by name) whose conversion by
    ``convert`` for ``cfg`` is the flat tree ``want`` (path -> numpy
    array); ``flatten`` flattens a converted tree the same way."""
    sd = {}
    for name, (path, layer) in _names(convert, cfg, want, flatten).items():
        leaf = want[path] if layer is None else want[path][layer]
        if path.endswith('kernel'):
            leaf = leaf.T
        sd[name] = torch.from_numpy(np.array(leaf))
    return sd
