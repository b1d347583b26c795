"""The weight bridge: every JAX param key consumed exactly once, with the
right shapes, into a strict load of the port's module (the transformer
and the RNN attention captioners)."""

import numpy as np
import pytest
import torch

from captioning_tpu.utils.misc import _flatten_tree
from captioning_tpu_torch.models.config import config_from_opt
from captioning_tpu_torch.models.harness import AttCaptioner
from captioning_tpu_torch.models.transformer import TransformerCaptioner
from captioning_tpu_torch.utils.weights import (_harness_name,
                                                 state_dict_from_jax)
from tests.torch_port_util import (LEGACY_MODELS, NO_ATT_MODELS, RNN_MODELS,
                                   V, jax_and_port, tiny_opt, tiny_rnn_opt)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('use_bn', [0, 2])
def test_bridge_consumes_every_key(use_bn):
    _, variables, _ = jax_and_port(use_bn=use_bn)
    cfg = config_from_opt(tiny_opt(use_bn=use_bn), V)
    flat = _flatten_tree(variables)
    sd = state_dict_from_jax(flat, cfg)
    module = TransformerCaptioner(cfg)
    ref = module.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    module.load_state_dict(sd, strict=True)
    # each JAX array lands somewhere: the numbers carried equal the numbers
    # read (stacked layer params count once per layer slice)
    assert sum(v.size for v in flat.values()) == sum(
        v.numel() for v in sd.values())
    # kernels are transposed into nn.Linear layout
    k = variables['params']['dec_src_wv_kernel'][1]
    np.testing.assert_array_equal(sd['dec.1.c_wv.weight'].numpy(), k.T)
    np.testing.assert_array_equal(
        sd['generator.weight'].numpy(),
        variables['params']['generator']['kernel'].T)


def test_bridge_rejects_leftover_and_missing_keys():
    _, variables, _ = jax_and_port()
    cfg = config_from_opt(tiny_opt(), V)
    flat = _flatten_tree(variables)
    with pytest.raises(KeyError, match='not consumed'):
        state_dict_from_jax(dict(flat, **{'params/extra': np.zeros(3)}), cfg)
    flat.pop('params/dec_norm3_a2')
    with pytest.raises(KeyError, match='missing'):
        state_dict_from_jax(flat, cfg)


def test_bridge_accepts_nested_tree_and_params_subtree():
    _, variables, _ = jax_and_port()
    cfg = config_from_opt(tiny_opt(), V)
    a = state_dict_from_jax(variables, cfg)
    b = state_dict_from_jax(variables['params'], cfg)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k])


@pytest.mark.parametrize('model', RNN_MODELS)
@pytest.mark.parametrize('use_bn,logit_layers', [(0, 1), (2, 2)])
def test_rnn_bridge_consumes_every_key(model, use_bn, logit_layers):
    opt = tiny_rnn_opt(model, use_bn=use_bn, logit_layers=logit_layers)
    _, variables, _ = jax_and_port(opt=opt)
    cfg = config_from_opt(opt, V)
    flat = _flatten_tree(variables)
    sd = state_dict_from_jax(flat, cfg)
    module = AttCaptioner(cfg)
    ref = module.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    module.load_state_dict(sd, strict=True)
    assert sum(v.size for v in flat.values()) == sum(
        v.numel() for v in sd.values())
    # every array lands under its own name, kernels transposed into
    # nn.Linear layout
    for key, value in flat.items():
        got = sd[_harness_name(key)].numpy()
        np.testing.assert_array_equal(
            got, value.T if key.endswith('/kernel') else value)
    p = variables['params']
    np.testing.assert_array_equal(sd['embed.embedding'].numpy(),
                                  p['embed']['embedding'])
    # the legacy logit has no hidden layers, whatever logit_layers says
    if logit_layers == 2 and model not in LEGACY_MODELS:
        np.testing.assert_array_equal(sd['logit_hidden.0.weight'].numpy(),
                                      p['logit_hidden_0']['kernel'].T)
    if model in ('stackatt', 'denseatt'):
        np.testing.assert_array_equal(sd['core.lstm1.h2h.weight'].numpy(),
                                      p['core']['lstm1']['h2h']['kernel'].T)
    if use_bn and model not in NO_ATT_MODELS + LEGACY_MODELS:
        np.testing.assert_array_equal(
            sd['att_bn_out.var'].numpy(),
            variables['batch_stats']['att_bn_out']['var'])


def test_rnn_bridge_rejects_leftover_and_missing_keys():
    opt = tiny_rnn_opt('updown')
    _, variables, _ = jax_and_port(opt=opt)
    cfg = config_from_opt(opt, V)
    flat = _flatten_tree(variables)
    with pytest.raises(KeyError, match='not consumed'):
        state_dict_from_jax(dict(flat, **{'params/core/extra/kernel':
                                          np.zeros((2, 2))}), cfg)
    # an att2in2 tree is no updown tree: a2c is left over, lstms missing
    a2i2 = tiny_rnn_opt('att2in2')
    _, a2i2_vars, _ = jax_and_port(opt=a2i2)
    with pytest.raises(KeyError, match='not consumed'):
        state_dict_from_jax(a2i2_vars, cfg)
    flat.pop('params/core/lang_lstm/hh/bias')
    with pytest.raises(KeyError, match='missing'):
        state_dict_from_jax(flat, cfg)
