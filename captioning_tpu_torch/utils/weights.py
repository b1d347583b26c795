"""Weight bridge: the JAX param tree <-> the port's ``state_dict``.

Input: ``Captioner.init_params(...)`` of the JAX package as numpy arrays
(the whole variables dict, or its ``'params'`` subtree), or
``misc.load_pytree(model.npz)``, or the flat ``{'params/...': array}`` dict
of ``misc._flatten_tree``.  Flax kernels are [in, out] and nn.Linear
weights [out, in]; the transformer's layer weights come stacked on a
leading [L] axis (``enc_self_wq_kernel`` [L, D, D], ``dec_norm1_a2``
[L, D], ...).  The RNN attention harness maps its keys one to one, since
the port's modules carry the JAX names (``core/attention/h2att/kernel`` ->
``core.attention.h2att.weight``, ``logit_hidden_0`` -> ``logit_hidden.0``,
``batch_stats/att_bn_in/mean`` -> ``att_bn_in.mean``); so does AoANet
(``refiner/attn_0/q/kernel`` -> ``refiner.attn_0.q.weight``,
``refiner/norm_out/a_2`` -> ``refiner.norm_out.a_2``), and so do the BERT
captioner and M2 (``enc_self_0/wq/kernel`` -> ``enc_self_0.wq.weight``,
``dec_gates_1_0/bias`` -> ``dec_gates_1_0.bias``, ``word_embed`` ->
``word_embed``).  Every JAX key is
consumed exactly once; a key left over or one the port needs but does not
find raises.  ``jax_from_state_dict`` is the inverse: the flat JAX tree
(``params/...`` and, with use_bn, ``batch_stats/...``), so a ``model.npz``
the port writes loads in the JAX package.  With ``params_only`` both map
a tree of the parameters alone (no BatchNorm statistics): the shape of the
optimizer's per-parameter state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import harness
from ..models.aoa import AoACaptioner
from ..models.bert_cap import BertCaptioner
from ..models.config import ModelConfig
from ..models.m2 import M2Captioner
from .misc import _flatten_tree

# stacked JAX prefix -> (port layer list, attribute)
_ENC = {'enc_self_wq': 'wq', 'enc_self_wk': 'wk', 'enc_self_wv': 'wv',
        'enc_self_wo': 'wo', 'enc_ffn_w1': 'w1', 'enc_ffn_w2': 'w2'}
_DEC = {'dec_self_wq': 's_wq', 'dec_self_wk': 's_wk', 'dec_self_wv': 's_wv',
        'dec_self_wo': 's_wo', 'dec_src_wq': 'c_wq', 'dec_src_wk': 'c_wk',
        'dec_src_wv': 'c_wv', 'dec_src_wo': 'c_wo', 'dec_ffn_w1': 'w1',
        'dec_ffn_w2': 'w2'}
_NORMS = {'enc': ('norm1', 'norm2'), 'dec': ('norm1', 'norm2', 'norm3')}
# the models whose port carries the JAX names, and their module classes
_ONE_TO_ONE = dict({m: harness.AttCaptioner for m in harness.MODELS},
                   aoa=AoACaptioner, bert=BertCaptioner,
                   m2transformer=M2Captioner)


def _flat(tree_or_flat) -> Dict[str, np.ndarray]:
    if tree_or_flat and all(isinstance(k, str) and '/' in k
                            for k in tree_or_flat):
        flat = dict(tree_or_flat)
    else:
        flat = _flatten_tree(tree_or_flat)
    if not any(k.startswith(('params/', 'batch_stats/')) for k in flat):
        flat = {'params/' + k: v for k, v in flat.items()}
    return {k: np.asarray(v) for k, v in flat.items()}


def state_dict_from_jax(tree_or_flat, cfg: ModelConfig,
                        params_only: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """The port's captioner's state_dict from JAX params."""
    if cfg.caption_model in _ONE_TO_ONE:
        return _harness_state_dict(_flat(tree_or_flat), cfg, params_only)
    if cfg.caption_model != 'transformer':
        raise ValueError('weight bridge: unknown caption model %r'
                         % cfg.caption_model)
    flat = _flat(tree_or_flat)
    out: Dict[str, torch.Tensor] = {}

    def take(key):
        if key not in flat:
            raise KeyError('weight bridge: JAX key %r missing' % key)
        return torch.from_numpy(np.array(flat.pop(key), np.float32))

    def linear(dst, kernel, bias):
        out[dst + '.weight'] = kernel.T.contiguous()
        out[dst + '.bias'] = bias

    linear('att_embed.Dense_0', take('params/att_embed/Dense_0/kernel'),
           take('params/att_embed/Dense_0/bias'))
    for bn in _bns(cfg):
        out[bn + '.scale'] = take('params/%s/scale' % bn)
        out[bn + '.bias'] = take('params/%s/bias' % bn)
        if not params_only:
            out[bn + '.mean'] = take('batch_stats/%s/mean' % bn)
            out[bn + '.var'] = take('batch_stats/%s/var' % bn)
    for part, names, L in (('enc', _ENC, cfg.N_enc),
                           ('dec', _DEC, cfg.N_dec)):
        for src, dst in names.items():
            kernels = take('params/%s_kernel' % src)
            biases = take('params/%s_bias' % src)
            for i in range(L):
                linear('%s.%d.%s' % (part, i, dst), kernels[i], biases[i])
        for j, norm in enumerate(_NORMS[part]):
            a = take('params/%s_norm%d_a2' % (part, j + 1))
            b = take('params/%s_norm%d_b2' % (part, j + 1))
            for i in range(L):
                out['%s.%d.%s.a_2' % (part, i, norm)] = a[i]
                out['%s.%d.%s.b_2' % (part, i, norm)] = b[i]
        out[part + '_final_norm.a_2'] = take('params/%s_final_norm/a_2'
                                             % part)
        out[part + '_final_norm.b_2'] = take('params/%s_final_norm/b_2'
                                             % part)
    out['tgt_embed'] = take('params/tgt_embed')
    linear('generator', take('params/generator/kernel'),
           take('params/generator/bias'))
    if flat:
        raise KeyError('weight bridge: JAX keys not consumed: %s'
                       % sorted(flat))
    return out


def _bns(cfg: ModelConfig):
    return ('att_bn_in', 'att_bn_out')[:2 if cfg.use_bn == 2 else
                                       1 if cfg.use_bn else 0]


def jax_from_state_dict(state_dict, cfg: ModelConfig,
                        params_only: bool = False) -> Dict[str, np.ndarray]:
    """The flat JAX tree (float32 numpy) of the port's state_dict: the
    inverse of ``state_dict_from_jax``."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    if cfg.caption_model in _ONE_TO_ONE:
        out = {}
        for name, value in sd.items():
            key = _jax_harness_key(name)
            if key.startswith('batch_stats/') and params_only:
                raise KeyError('jax_from_state_dict: %r is no parameter'
                               % name)
            out[key] = (value.T.copy() if key.endswith('/kernel')
                        else value)
        return out
    if cfg.caption_model != 'transformer':
        raise ValueError('weight bridge: unknown caption model %r'
                         % cfg.caption_model)

    def take(name):
        if name not in sd:
            raise KeyError('weight bridge: port key %r missing' % name)
        return sd.pop(name)

    out = {}

    def linear(src, kernel, bias):
        out[kernel] = take(src + '.weight').T.copy()
        out[bias] = take(src + '.bias')

    linear('att_embed.Dense_0', 'params/att_embed/Dense_0/kernel',
           'params/att_embed/Dense_0/bias')
    for bn in _bns(cfg):
        out['params/%s/scale' % bn] = take(bn + '.scale')
        out['params/%s/bias' % bn] = take(bn + '.bias')
        if not params_only:
            out['batch_stats/%s/mean' % bn] = take(bn + '.mean')
            out['batch_stats/%s/var' % bn] = take(bn + '.var')
    for part, names, L in (('enc', _ENC, cfg.N_enc),
                           ('dec', _DEC, cfg.N_dec)):
        for dst, src in names.items():
            out['params/%s_kernel' % dst] = np.stack(
                [take('%s.%d.%s.weight' % (part, i, src)).T
                 for i in range(L)])
            out['params/%s_bias' % dst] = np.stack(
                [take('%s.%d.%s.bias' % (part, i, src)) for i in range(L)])
        for j, norm in enumerate(_NORMS[part]):
            for ab, leaf in (('a', 'a_2'), ('b', 'b_2')):
                out['params/%s_norm%d_%s2' % (part, j + 1, ab)] = np.stack(
                    [take('%s.%d.%s.%s' % (part, i, norm, leaf))
                     for i in range(L)])
        for leaf in ('a_2', 'b_2'):
            out['params/%s_final_norm/%s' % (part, leaf)] = take(
                '%s_final_norm.%s' % (part, leaf))
    out['params/tgt_embed'] = take('tgt_embed')
    linear('generator', 'params/generator/kernel', 'params/generator/bias')
    if sd:
        raise KeyError('weight bridge: port keys not consumed: %s'
                       % sorted(sd))
    return out


def _jax_harness_key(name: str) -> str:
    """'core.att_lstm.ih.weight' -> 'params/core/att_lstm/ih/kernel';
    a BatchNorm's running statistics go to 'batch_stats/...'."""
    parts = name.split('.')
    if parts[0] == 'logit_hidden':
        parts[0:2] = ['logit_hidden_' + parts[1]]
    if parts[-1] == 'weight':
        parts[-1] = 'kernel'
    coll = ('batch_stats' if parts[0].startswith('att_bn_')
            and parts[-1] in ('mean', 'var') else 'params')
    return '/'.join([coll] + parts)


def _harness_name(key: str) -> str:
    """'params/core/att_lstm/ih/kernel' -> 'core.att_lstm.ih.weight'."""
    parts = key.split('/')[1:]
    if parts[0].startswith('logit_hidden_'):
        parts[0:1] = ['logit_hidden', parts[0][len('logit_hidden_'):]]
    if parts[-1] == 'kernel':
        parts[-1] = 'weight'
    return '.'.join(parts)


def _harness_state_dict(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                        params_only: bool = False
                        ) -> Dict[str, torch.Tensor]:
    with torch.device('meta'):
        module = _ONE_TO_ONE[cfg.caption_model](cfg)
    want = (dict(module.named_parameters()) if params_only
            else module.state_dict())
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(flat):
        name = _harness_name(key)
        if name not in want or name in out:
            continue
        value = torch.from_numpy(np.array(flat.pop(key), np.float32))
        if key.endswith('/kernel'):
            value = value.T.contiguous()        # [in, out] -> [out, in]
        if tuple(value.shape) != tuple(want[name].shape):
            raise ValueError('weight bridge: %s has shape %s, the port needs '
                             '%s' % (key, tuple(value.shape),
                                     tuple(want[name].shape)))
        out[name] = value
    if flat:
        raise KeyError('weight bridge: JAX keys not consumed: %s'
                       % sorted(flat))
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError('weight bridge: JAX keys for %s missing' % missing)
    return out
