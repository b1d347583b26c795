"""Convert reference PyTorch checkpoints into the JAX param trees that
``model.npz`` holds (port of ``captioning_tpu/utils/torch_convert.py``,
the same code: numpy only, ``torch.load`` in ``convert_checkpoint``).

Lets users of ``ruotianluo/ImageCaptioning.pytorch`` bring their trained
``model.pth`` state_dicts into a run directory of the port:

    python tools/import_torch_checkpoint_torch.py \
        --infos_path log_x/infos_x.pkl --model log_x/model.pth \
        --output_dir log_x_port --id x

Every supported family maps key-for-key (Linear weights transpose
[out, in] -> [in, out]); ``bert`` and ``m2transformer`` have no upstream
checkpoint layout here and raise, as in the original.  The copy is held
against the original in ``tests/test_torch_import.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _a(w):
    return np.asarray(w)


class _TreeBuilder:
    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.batch_stats: Dict[str, Any] = {}

    def set(self, path: str, value, collection='params'):
        node = self.params if collection == 'params' else self.batch_stats
        parts = path.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value, np.float32)

    def linear(self, dst: str, sd, src: str):
        self.set(dst + '/kernel', _t(sd[src + '.weight']))
        if src + '.bias' in sd:
            self.set(dst + '/bias', _a(sd[src + '.bias']))

    def norm(self, dst: str, sd, src: str):
        self.set(dst + '/a_2', _a(sd[src + '.a_2']))
        self.set(dst + '/b_2', _a(sd[src + '.b_2']))

    def lstm_cell(self, dst: str, sd, src: str):
        """torch nn.LSTMCell -> TorchLSTMCell (ih/hh Dense pair)."""
        self.set(dst + '/ih/kernel', _t(sd[src + '.weight_ih']))
        self.set(dst + '/ih/bias', _a(sd[src + '.bias_ih']))
        self.set(dst + '/hh/kernel', _t(sd[src + '.weight_hh']))
        self.set(dst + '/hh/bias', _a(sd[src + '.bias_hh']))

    def batchnorm(self, dst: str, sd, src: str):
        self.set(dst + '/scale', _a(sd[src + '.weight']))
        self.set(dst + '/bias', _a(sd[src + '.bias']))
        self.set(dst + '/mean', _a(sd[src + '.running_mean']), 'batch_stats')
        self.set(dst + '/var', _a(sd[src + '.running_var']), 'batch_stats')

    def attention(self, dst: str, sd, src: str):
        self.linear(dst + '/h2att', sd, src + '.h2att')
        self.linear(dst + '/alpha_net', sd, src + '.alpha_net')

    def done(self):
        out = {'params': self.params}
        if self.batch_stats:
            out['batch_stats'] = self.batch_stats
        return out


def _att_base(b: _TreeBuilder, sd, cfg):
    """AttModel shared embeds (reference AttModel.py:74-93)."""
    m = cfg.caption_model
    plain_embed = m in ('att2in', 'newfc', 'language_model', 'fc',
                        'show_tell')
    b.set('embed/embedding',
          _a(sd['embed.weight' if plain_embed else 'embed.0.weight']))
    # fc_embed
    if m in ('updown', 'topdown', 'adaatt', 'adaattmo', 'stackatt',
             'denseatt', 'transformer'):
        if m != 'transformer':
            b.linear('fc_embed/Dense_0', sd, 'fc_embed.0')
    elif m in ('newfc',):
        b.linear('fc_embed', sd, 'fc_embed')
    elif m in ('fc', 'show_tell'):
        b.linear('fc_embed', sd, 'img_embed')
    # att_embed (+optional BN)
    if m not in ('att2in', 'newfc', 'language_model', 'fc', 'show_tell'):
        i = 0
        if cfg.use_bn:
            b.batchnorm('att_bn_in', sd, 'att_embed.%d' % i)
            i += 1
        b.linear('att_embed/Dense_0', sd, 'att_embed.%d' % i)
        if cfg.use_bn == 2:
            b.batchnorm('att_bn_out', sd, 'att_embed.%d' % (i + 3))
    # ctx2att / logit
    if m not in ('newfc', 'language_model', 'fc', 'show_tell',
                 'transformer'):
        b.linear('ctx2att', sd, 'ctx2att')
    if m != 'transformer':
        b.linear('logit', sd, 'logit')


def convert_state_dict(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """state_dict (numpy-able values) -> flax variables for model `cfg`."""
    # np.array (not asarray): torch's .numpy() SHARES storage with the live
    # parameter, and in-place optimizer.step() on the torch side would
    # silently mutate any un-transposed weight we kept as a view
    sd = {k: np.array(v.numpy() if hasattr(v, 'numpy') else v)
          for k, v in sd.items()}
    m = cfg.caption_model
    b = _TreeBuilder()

    if m == 'transformer':
        _convert_transformer(b, sd, cfg)
        return b.done()
    if m == 'aoa':
        _convert_aoa(b, sd, cfg)
        return b.done()

    _att_base(b, sd, cfg)

    if m in ('att2in', 'att2in2'):
        b.linear('core/i2h', sd, 'core.i2h')
        b.linear('core/h2h', sd, 'core.h2h')
        b.linear('core/a2c', sd, 'core.a2c')
        b.attention('core/attention', sd, 'core.attention')
    elif m == 'att2all2':
        b.linear('core/i2h', sd, 'core.i2h')
        b.linear('core/h2h', sd, 'core.h2h')
        b.linear('core/a2h', sd, 'core.a2h')
        b.attention('core/attention', sd, 'core.attention')
    elif m in ('updown', 'topdown'):
        b.lstm_cell('core/att_lstm', sd, 'core.att_lstm')
        b.lstm_cell('core/lang_lstm', sd, 'core.lang_lstm')
        b.attention('core/attention', sd, 'core.attention')
    elif m in ('stackatt', 'denseatt'):
        for i in range(3):
            b.linear('core/lstm%d/i2h' % i, sd, 'core.lstm%d.i2h' % i)
            b.linear('core/lstm%d/h2h' % i, sd, 'core.lstm%d.h2h' % i)
        b.attention('core/att1', sd, 'core.att1')
        b.attention('core/att2', sd, 'core.att2')
        b.linear('core/emb2', sd, 'core.emb2')
        if m == 'denseatt':
            b.linear('core/fusion1/Dense_0', sd, 'core.fusion1.0')
            b.linear('core/fusion2/Dense_0', sd, 'core.fusion2.0')
    elif m in ('adaatt', 'adaattmo'):
        b.linear('core/w2h', sd, 'core.lstm.w2h')
        b.linear('core/v2h', sd, 'core.lstm.v2h')
        for i in range(cfg.num_layers - 1):
            b.linear('core/i2h_%d' % i, sd, 'core.lstm.i2h.%d' % i)
        for i in range(cfg.num_layers):
            b.linear('core/h2h_%d' % i, sd, 'core.lstm.h2h.%d' % i)
        if cfg.num_layers == 1:
            b.linear('core/r_w2h', sd, 'core.lstm.r_w2h')
            b.linear('core/r_v2h', sd, 'core.lstm.r_v2h')
        else:
            b.linear('core/r_i2h', sd, 'core.lstm.r_i2h')
        b.linear('core/r_h2h', sd, 'core.lstm.r_h2h')
        b.linear('core/fr_linear', sd, 'core.attention.fr_linear.0')
        b.linear('core/fr_embed', sd, 'core.attention.fr_embed')
        b.linear('core/ho_linear', sd, 'core.attention.ho_linear.0')
        b.linear('core/ho_embed', sd, 'core.attention.ho_embed')
        b.linear('core/alpha_net', sd, 'core.attention.alpha_net')
        b.linear('core/att2h', sd, 'core.attention.att2h')
    elif m in ('newfc', 'language_model'):
        b.linear('core/lstm/i2h', sd, '_core.i2h')
        b.linear('core/lstm/h2h', sd, '_core.h2h')
    elif m == 'fc':
        b.linear('core/lstm/i2h', sd, 'core.i2h')
        b.linear('core/lstm/h2h', sd, 'core.h2h')
    elif m == 'show_tell':
        for l in range(cfg.num_layers):
            b.set('core/ih_%d/kernel' % l, _t(sd['core.weight_ih_l%d' % l]))
            b.set('core/hh_%d/kernel' % l, _t(sd['core.weight_hh_l%d' % l]))
    else:
        raise ValueError('unsupported caption_model %s' % m)
    return b.done()


def _convert_transformer(b: _TreeBuilder, sd, cfg):
    """reference TransformerModel (TransformerModel.py:237-298)."""
    i0 = 1 if cfg.use_bn else 0
    if cfg.use_bn:
        b.batchnorm('att_bn_in', sd, 'att_embed.0')
    b.linear('att_embed/Dense_0', sd, 'att_embed.%d' % i0)
    if cfg.use_bn == 2:
        b.batchnorm('att_bn_out', sd, 'att_embed.%d' % (i0 + 3))

    # layer weights are STACKED on a leading [L] axis (the flax model scans
    # over the stacks at eval; models/transformer.py setup)
    def stack_linear(dst, srcs):
        b.set(dst + '_kernel', np.stack([_t(sd[s + '.weight']) for s in srcs]))
        b.set(dst + '_bias', np.stack([_a(sd[s + '.bias']) for s in srcs]))

    def stack_norm(dst, srcs):
        b.set(dst + '_a2', np.stack([_a(sd[s + '.a_2']) for s in srcs]))
        b.set(dst + '_b2', np.stack([_a(sd[s + '.b_2']) for s in srcs]))

    names = ['wq', 'wk', 'wv', 'wo']
    enc = ['model.encoder.layers.%d.' % i for i in range(cfg.N_enc)]
    for j, n in enumerate(names):
        stack_linear('enc_self_%s' % n,
                     [e + 'self_attn.linears.%d' % j for e in enc])
    stack_linear('enc_ffn_w1', [e + 'feed_forward.w_1' for e in enc])
    stack_linear('enc_ffn_w2', [e + 'feed_forward.w_2' for e in enc])
    stack_norm('enc_norm1', [e + 'sublayer.0.norm' for e in enc])
    stack_norm('enc_norm2', [e + 'sublayer.1.norm' for e in enc])
    b.norm('enc_final_norm', sd, 'model.encoder.norm')

    dec = ['model.decoder.layers.%d.' % i for i in range(cfg.N_dec)]
    for j, n in enumerate(names):
        stack_linear('dec_self_%s' % n,
                     [d + 'self_attn.linears.%d' % j for d in dec])
        stack_linear('dec_src_%s' % n,
                     [d + 'src_attn.linears.%d' % j for d in dec])
    stack_linear('dec_ffn_w1', [d + 'feed_forward.w_1' for d in dec])
    stack_linear('dec_ffn_w2', [d + 'feed_forward.w_2' for d in dec])
    stack_norm('dec_norm1', [d + 'sublayer.0.norm' for d in dec])
    stack_norm('dec_norm2', [d + 'sublayer.1.norm' for d in dec])
    stack_norm('dec_norm3', [d + 'sublayer.2.norm' for d in dec])
    b.norm('dec_final_norm', sd, 'model.decoder.norm')

    b.set('tgt_embed', _a(sd['model.tgt_embed.0.lut.weight']))
    b.linear('generator', sd, 'model.generator.proj')


def _convert_aoa(b: _TreeBuilder, sd, cfg):
    """reference AoAModel (AoAModel.py:188-226)."""
    b.set('embed/embedding', _a(sd['embed.0.weight']))
    i0 = 1 if cfg.use_bn else 0
    if cfg.use_bn:
        b.batchnorm('att_bn_in', sd, 'att_embed.0')
    b.linear('att_embed/Dense_0', sd, 'att_embed.%d' % i0)
    b.linear('ctx2att', sd, 'ctx2att')
    b.linear('logit', sd, 'logit')
    if not cfg.mean_feats:
        b.linear('fc_embed/Dense_0', sd, 'fc_embed.0')

    def mha(dst, src, project_k_v, do_aoa, norm_q, use_out):
        b.linear(dst + '/q', sd, src + '.linears.0')
        if project_k_v:
            b.linear(dst + '/k', sd, src + '.linears.1')
            b.linear(dst + '/v', sd, src + '.linears.2')
        if norm_q:
            b.norm(dst + '/norm', sd, src + '.norm')
        if do_aoa:
            b.linear(dst + '/aoa', sd, src + '.aoa_layer.0')
        elif use_out:
            b.linear(dst + '/out', sd, src + '.output_layer')

    if cfg.refine:
        for i in range(6):
            base = 'refiner.layers.%d.' % i
            mha('refiner/attn_%d' % i, base + 'self_attn', 1,
                cfg.refine_aoa, 0, not cfg.refine_aoa)
            b.norm('refiner/norm1_%d' % i, sd, base + 'sublayer.0.norm')
            if cfg.use_ff:
                b.linear('refiner/ff1_%d' % i, sd, base + 'feed_forward.w_1')
                b.linear('refiner/ff2_%d' % i, sd, base + 'feed_forward.w_2')
                b.norm('refiner/norm2_%d' % i, sd, base + 'sublayer.1.norm')
        b.norm('refiner/norm_out', sd, 'refiner.norm')

    b.lstm_cell('att_lstm', sd, 'core.att_lstm')
    if cfg.use_multi_head == 2:
        # project_k_v=0, use_output_layer=0, norm_q=1 (AoAModel.py:154)
        b.linear('attention/q', sd, 'core.attention.linears.0')
        b.norm('attention/norm', sd, 'core.attention.norm')
    else:
        b.attention('attention', sd, 'core.attention')
    if cfg.decoder_type == 'AoA':
        b.linear('att2ctx', sd, 'core.att2ctx.0')
    elif cfg.decoder_type == 'LSTM':
        b.lstm_cell('att2ctx_lstm', sd, 'core.att2ctx')
    else:
        b.linear('att2ctx', sd, 'core.att2ctx.0')


def convert_checkpoint(model_pth: str, cfg):
    import torch
    sd = torch.load(model_pth, map_location='cpu')
    return convert_state_dict(sd, cfg)
