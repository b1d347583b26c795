"""Shared set-up of the PyTorch port's parity tests: one tiny model (the
transformer, or an RNN attention captioner of ``tiny_rnn_opt``)
initialised by the JAX package and loaded into the port, fed the same
numpy inputs on both sides (float32, CPU)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

V = 29          # vocab; index V is 'UNK' so suppress_UNK has a target
M = 5           # regions


def tiny_opt(**kw):
    opt = SimpleNamespace(
        caption_model='transformer', vocab_size=V, input_encoding_size=16,
        rnn_size=32, num_layers=2, drop_prob_lm=0.0, fc_feat_size=10,
        att_feat_size=12, att_hid_size=16, seq_per_img=5, max_length=8,
        N_enc=2, N_dec=2, d_model=32, d_ff=48, num_att_heads=4,
        dropout=0.0, use_pallas=1, use_bn=0)
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


RNN_MODELS = ('updown', 'att2in2', 'att2all2', 'stackatt', 'denseatt',
              'newfc', 'fc', 'language_model', 'adaatt', 'adaattmo')


def tiny_rnn_opt(caption_model='updown', **kw):
    """An RNN captioner at tiny widths that all differ (so a swapped
    dimension cannot pass): rnn 24, word embedding 20, attention hidden 12,
    fc 10, att 12.  AdaAtt joins its sentinel [word embedding width] to the
    regions [rnn width], so there both are 24 (as
    tests/test_reference_parity.py sizes it); its num_layers is 2."""
    E = 24 if caption_model in ('adaatt', 'adaattmo') else 20
    return tiny_opt(**dict(dict(caption_model=caption_model, rnn_size=24,
                                input_encoding_size=E, att_hid_size=12),
                           **kw))


def tiny_vocab():
    vocab = {str(i): 'w%d' % i for i in range(1, V + 1)}
    vocab[str(V)] = 'UNK'
    return vocab


def jax_and_port(seed=0, eos_boost=0.0, opt=None, **kw):
    """(JAX Captioner, its variables as numpy, port Captioner) for ``opt``
    (default ``tiny_opt(**kw)``).

    ``eos_boost`` raises the vocab projection's EOS bias so captions end
    early (the early exits then fire)."""
    import jax
    import torch

    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu_torch.models.api import setup as port_setup

    opt = opt or tiny_opt(**kw)
    jcap = jax_setup(opt, tiny_vocab())
    variables = jax.device_get(jcap.init_params(jax.random.PRNGKey(seed),
                                                att_len=M))
    variables = jax.tree.map(np.asarray, variables)
    if eos_boost:
        out = variables['params'][
            'generator' if 'generator' in variables['params'] else 'logit']
        out['bias'] = out['bias'].copy()
        out['bias'][0] += eos_boost
    pcap = port_setup(opt, tiny_vocab(), device='cpu').load_jax_variables(
        variables)
    torch.manual_seed(0)
    return jcap, variables, pcap


def inputs(B=4, seed=0, ragged=True):
    """fc [B, 10], att [B, M, 12], att_masks [B, M] (some rows ragged)."""
    rng = np.random.RandomState(seed)
    fc = rng.randn(B, 10).astype('float32')
    att = rng.randn(B, M, 12).astype('float32')
    am = np.ones((B, M), 'float32')
    if ragged:
        am[1::2, 3:] = 0
    return fc, att, am
