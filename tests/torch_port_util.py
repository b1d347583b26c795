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


def bad_endings_vocab():
    """``tiny_vocab`` with bad-ending words (the ones ``remove_bad_endings``
    bans before EOS) at ids 2, 5 and 9."""
    vocab = tiny_vocab()
    vocab.update({'2': 'a', '5': 'the', '9': 'of'})
    return vocab


def jax_and_port(seed=0, eos_boost=0.0, opt=None, vocab=None, **kw):
    """(JAX Captioner, its variables as numpy, port Captioner) for ``opt``
    (default ``tiny_opt(**kw)``) and ``vocab`` (default ``tiny_vocab()``).

    ``eos_boost`` raises the vocab projection's EOS bias so captions end
    early (the early exits then fire)."""
    import jax
    import torch

    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu_torch.models.api import setup as port_setup

    opt = opt or tiny_opt(**kw)
    vocab = vocab or tiny_vocab()
    jcap = jax_setup(opt, vocab)
    variables = jax.device_get(jcap.init_params(jax.random.PRNGKey(seed),
                                                att_len=M))
    variables = jax.tree.map(np.asarray, variables)
    if eos_boost:
        out = variables['params'][
            'generator' if 'generator' in variables['params'] else 'logit']
        out['bias'] = out['bias'].copy()
        out['bias'][0] += eos_boost
    pcap = port_setup(opt, vocab, device='cpu').load_jax_variables(
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


def train_opt(opt, **kw):
    """``opt`` with the XE trainer's options: adam 1e-2 (a rate large
    enough that 3 steps move the loss), clip by value 0.1, dropout 0 (the
    torch and JAX streams never agree), no label smoothing."""
    base = dict(optim='adam', learning_rate=1e-2, optim_alpha=0.9,
                optim_beta=0.999, optim_epsilon=1e-8, weight_decay=0.0,
                grad_clip_mode='value', grad_clip_value=0.1, noamopt=False,
                label_smoothing=0, drop_worst_rate=0.0, drop_prob_lm=0.0,
                dropout=0.0)
    for k, v in dict(base, **kw).items():
        setattr(opt, k, v)
    return opt


def train_batch(B=4, spi=5, L=6, seed=0):
    """labels / masks [B, seq_per_img, L + 2] as the loader gives them: a
    0 (BOS) column, captions of 2..L tokens, a trailing 0; the mask covers
    BOS, the tokens and the first 0 after them."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(2, L + 1, (B, spi))
    labels = np.zeros((B, spi, L + 2), np.int64)
    tok = rng.randint(1, V, (B, spi, L))
    pos = np.arange(L)
    labels[..., 1:L + 1] = np.where(pos < lengths[..., None], tok, 0)
    masks = (np.arange(L + 2) <= lengths[..., None] + 1).astype('float32')
    return labels, masks


def jax_draws(seed, steps):
    """The port's ``draw(kind, t, shape)`` returning the JAX engine's noise
    for ``jax.random.PRNGKey(seed)``: ``sample`` and ``diverse_sample``
    split off the prepare key, split the rest into ``steps`` x 2 step keys
    and sample step t with key [t, 1] (a uniform for gumbel sampling, the
    gumbel of ``jax.random.categorical`` otherwise)."""
    import jax
    import torch

    rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.split(rng, steps * 2).reshape(steps, 2, -1)

    def draw(kind, t, shape):
        fn = jax.random.uniform if kind == 'uniform' else jax.random.gumbel
        return torch.from_numpy(np.array(fn(keys[t, 1], tuple(shape))))
    return draw
