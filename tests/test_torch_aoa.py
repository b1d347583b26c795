"""AoANet (``captioning_tpu_torch/models/aoa.py``) against the JAX
package's (``captioning_tpu/models/aoa.py``) on the same weights and
inputs, float32 on the CPU, at tiny widths (rnn 32 in 4 heads, word
embedding 20; the refiner keeps its 6 layers):

* ``MultiHeadedDotAttention`` in each form: per-row and block-shared K/V,
  with and without the query LayerNorm, the K/V projections, the AoA gate
  or the output layer, ``multi_head_scale`` 2, masks with padded regions;
  the refiner with ``use_ff`` 0 and 1; atol 1e-5;
* ``prepare_feature``, the per-step log-probs and logits and the state
  over 3 steps (per query row and block-shared by 5 beam lanes), for each
  ``decoder_type``, ``out_res``, ``mean_feats``, ``use_multi_head`` 2 and
  0, ``use_bn`` 0 / 1 / 2, no refiner; eval ``forward_tf``; atol 1e-5;
* the decodes: greedy and beam 5 (both attention routes), the general and
  diverse beam with the replay, every sampling method with JAX's noise,
  diverse sampling: tokens identical, sums within 1e-4;
* the weight bridge both ways, ``batch_stats`` included; the port's own
  init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.utils.misc import _flatten_tree
from captioning_tpu_torch.models import aoa as paoa
from captioning_tpu_torch.models.config import config_from_opt
from captioning_tpu_torch.utils.weights import (_harness_name,
                                                 jax_from_state_dict,
                                                 state_dict_from_jax)
from tests import test_torch_general_beam as general_beam
from tests.torch_port_util import (V, bad_endings_vocab, inputs, jax_and_port,
                                   jax_draws, tiny_aoa_opt)

ATOL, SUM_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _load(module, params):
    """``module`` with the JAX ``params`` tree (names one to one, kernels
    transposed)."""
    flat = _flatten_tree({'params': jax.tree.map(np.asarray, params)})
    sd = {}
    for key, value in flat.items():
        value = torch.from_numpy(np.array(value, np.float32))
        sd[_harness_name(key)] = (value.T.contiguous()
                                  if key.endswith('/kernel') else value)
    module.load_state_dict(sd, strict=True)
    return module


def _mask(nb, M, masked):
    if not masked:
        return None
    am = np.ones((nb, M), 'float32')
    am[1::2, 3:] = 0
    return am


# form -> (module options, block-shared K/V, one query row a lane)
FORMS = {
    'refiner-aoa': (dict(project_k_v=1, do_aoa=1), False, False),
    'refiner-out': (dict(project_k_v=1, do_aoa=0), False, False),
    'decoder': (dict(project_k_v=0, use_output_layer=0, norm_q=1), False,
                True),
    'decoder-shared': (dict(project_k_v=0, use_output_layer=0, norm_q=1),
                       True, True),
    'decoder-scale2': (dict(project_k_v=0, use_output_layer=0, norm_q=1,
                            scale=2), False, True),
    'shared-aoa-scale2': (dict(project_k_v=1, do_aoa=1, norm_q=1, scale=2),
                          True, True),
    'shared-out': (dict(project_k_v=1, do_aoa=0), True, True),
}


@pytest.mark.parametrize('masked', [0, 1])
@pytest.mark.parametrize('form', sorted(FORMS))
def test_multi_headed_dot_attention_matches_jax(form, masked):
    from captioning_tpu.models import aoa as jaoa
    kw, shared, single = FORMS[form]
    h, D, nb, M = 4, 16, 3, 5
    kv = kw.get('scale', 1) * D if not kw['project_k_v'] else D
    rng = np.random.RandomState(len(form) + masked)
    mem = rng.randn(nb, M, kv).astype('float32')
    mem2 = rng.randn(nb, M, kv).astype('float32')
    if single:
        n = nb * (5 if shared else 1)
        query = rng.randn(n, D).astype('float32')
        value, key = mem, mem2
        if not shared:
            value, key = mem[:n], mem2[:n]
    else:
        query = value = key = rng.randn(nb, M, D).astype('float32')
    mask = _mask(nb, M, masked)
    jm = jaoa.MultiHeadedDotAttention(h, D, **kw)
    args = [jnp.asarray(a) if a is not None else None
            for a in (query, value, key, mask)]
    variables = jm.init(jax.random.PRNGKey(0), *args, False)
    want = jm.apply(variables, *args, False)
    pm = _load(paoa.MultiHeadedDotAttention(h, D, **kw), variables['params'])
    got = pm(*[torch.from_numpy(a) if a is not None else None
               for a in (query, value, key, mask)])
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.detach(), want)


@pytest.mark.parametrize('use_ff', [0, 1])
def test_refiner_matches_jax(use_ff):
    from captioning_tpu.models import aoa as jaoa
    from captioning_tpu.models.harness import config_from_opt as jax_cfg
    opt = tiny_aoa_opt(use_ff=use_ff)
    rng = np.random.RandomState(use_ff)
    x = rng.randn(3, 5, 32).astype('float32')
    mask = _mask(3, 5, True)
    jm = jaoa.AoARefiner(jax_cfg(opt, V))
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                        jnp.asarray(mask), False)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    pm = _load(paoa.AoARefiner(config_from_opt(opt, V)), variables['params'])
    _close(pm(torch.from_numpy(x), torch.from_numpy(mask)).detach(), want)


# the captioner's options: each decoder type, out_res, mean_feats, both
# attention routes, each use_bn, no refiner, no ctx_drop
CONFIGS = {
    'aoa': {},
    'lstm-res-fc': dict(decoder_type='LSTM', out_res=1, mean_feats=0),
    'plain-head-bn1': dict(decoder_type='base', use_multi_head=0, use_bn=1,
                           ctx_drop=0),
    'bn2-ff-scale2': dict(use_bn=2, use_ff=1, refine_aoa=0,
                          multi_head_scale=2),
    'norefine-res': dict(refine=0, out_res=1),
}


def _randomise_bn(variables):
    """Non-trivial running statistics and affine parameters for the eval
    branch of the BatchNorms."""
    rng = np.random.RandomState(1)
    for coll, name, f in (('batch_stats', 'mean', 0.5),
                          ('batch_stats', 'var', 1.0),
                          ('params', 'scale', 0.3), ('params', 'bias', 0.3)):
        for bn in [b for b in ('att_bn_in', 'att_bn_out')
                   if b in variables.get(coll, {})]:
            a = variables[coll][bn][name]
            variables[coll][bn][name] = (
                np.abs(rng.randn(*a.shape)) * f + (name == 'var')
                ).astype('float32')


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_prepare_and_steps_match_jax(config):
    jcap, variables, pcap = jax_and_port(opt=tiny_aoa_opt(**CONFIGS[config]))
    if 'batch_stats' in variables:
        _randomise_bn(variables)
        pcap.load_jax_variables(variables)
    jm, pm = jcap.module, pcap.module
    B = 3
    fc, att, am = inputs(B=B)
    feats_j = jm.apply(variables, *map(jnp.asarray, (fc, att, am)), False,
                       method=type(jm).prepare_feature)
    feats_p = pm.prepare_feature(*map(torch.from_numpy, (fc, att, am)))
    assert set(feats_p) == set(feats_j)
    for key in feats_j:
        _close(feats_p[key], feats_j[key])
    rng = np.random.RandomState(0)
    for bw in (0, 5):
        N = B * max(bw, 1)
        st_j, st_p = jm.init_state(N), pm.init_state(N)
        assert tuple(st_p['h'].shape) == tuple(st_j['h'].shape)
        for t in range(3):
            if bw and t:
                # rows inherit a parent within their block
                parent = (np.arange(N) // bw) * bw + rng.randint(0, bw, N)
                st_j = {k: v[parent] for k, v in st_j.items()}
                idx = torch.from_numpy(parent)
                st_p = dict(st_p, h=st_p['h'][idx], c=st_p['c'][idx])
            it = rng.randint(0, V + 1, N).astype('int32')
            for lsm in (False, True):
                out_j, nst_j = jm.apply(variables, jnp.asarray(it), feats_j,
                                        st_j, False, lsm, True, bw,
                                        method=type(jm).step)
                out_p, nst_p = pm.step(torch.from_numpy(it).long(), feats_p,
                                       st_p, lsm, True, bw)
                assert out_p.dtype == torch.float32
                _close(out_p, out_j)
            st_j, st_p = nst_j, nst_p
            _close(st_p['h'], st_j['h'])
            _close(st_p['c'], st_j['c'])


@pytest.mark.parametrize('config', ['aoa', 'plain-head-bn1', 'lstm-res-fc'])
def test_forward_tf_matches_jax(config):
    """Teacher forcing over labels [B, seq_per_img, T]: the 5 captions of
    an image share its feats row."""
    jcap, variables, pcap = jax_and_port(opt=tiny_aoa_opt(**CONFIGS[config]))
    B, S, T = 2, 5, 6
    fc, att, am = inputs(B=B)
    seq = np.random.RandomState(2).randint(1, V + 1, (B, S, T)).astype(
        'int32')
    seq[..., 0] = 0
    seq[0, 1, 3:] = 0
    want = jcap.forward_tf(variables, *map(jnp.asarray, (fc, att, seq, am)))
    got = pcap.forward_tf(torch.from_numpy(fc), torch.from_numpy(att),
                          torch.from_numpy(seq).long(), torch.from_numpy(am))
    assert tuple(got.shape) == tuple(want.shape) == (B * S, T, V + 1)
    _close(got, want)


# the decodes: one JAX captioner per attention route, its compiled programs
# reused across the cases; every route of the engine on the dot attention
# (use_multi_head 2, the configs' route), beam 5 and greedy on the
# additive head too
@pytest.fixture(scope='module')
def models():
    return jax_and_port(seed=3, opt=tiny_aoa_opt(),
                        vocab=bad_endings_vocab())


@pytest.fixture(scope='module')
def head_models():
    return jax_and_port(seed=3, opt=tiny_aoa_opt(use_multi_head=0),
                        vocab=bad_endings_vocab())


@pytest.fixture(params=['multi_head', 'head'])
def either(request):
    return request.getfixturevalue('models' if request.param == 'multi_head'
                                   else 'head_models')


def _jax_in(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize('lp', ['', 'wu_0.9'])
def test_beam5_matches_jax(either, lp):
    jcap, variables, pcap = either
    fc, att, am = inputs(B=4, seed=5)
    opt = {'beam_size': 5, 'sample_n': 1, 'group_size': 1,
           'suppress_UNK': 1, 'length_penalty': lp}
    js, jst, jdone = jcap.sample_beam_jit(
        variables, *_jax_in(fc, att, am), jax.random.PRNGKey(1), opt,
        want_logps=False)
    ps, pst, pdone = pcap.sample_beam(*_torch(fc, att, am), None, opt)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pdone['seq'].numpy(),
                                  np.asarray(jdone['seq']))
    for key in ('ent_sum', 'lp_sum'):
        _close(pst[key], jst[key], SUM_ATOL)
    # the graph entry's program, run eagerly on the CPU
    gs, gst, _ = pcap.sample_beam_graphed(*_torch(fc, att, am), None, opt)
    assert torch.equal(gs, ps)


def test_greedy_matches_jax(either):
    jcap, variables, pcap = either
    fc, att, am = inputs(B=6, seed=11)
    opt = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}
    js, jst = jcap.sample_stats_jit(variables, *_jax_in(fc, att, am),
                                    jax.random.PRNGKey(1), opt)
    ps, pst = pcap.sample_stats(*_torch(fc, att, am), None, opt)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    for key in ('ent_sum', 'lp_sum'):
        _close(pst[key], jst[key], SUM_ATOL)
    gs, _ = pcap.sample_stats_graphed(*_torch(fc, att, am), None, opt)
    assert torch.equal(gs, ps)


@pytest.mark.parametrize('case', ['G1-general-unk-wu', 'G3-avg',
                                  'G2-constraints'])
def test_general_and_diverse_beam_match_jax(models, case):
    """The general body, diverse groups and the constraints, with the
    winner-logprob replay (``want_logps``)."""
    general_beam._check(*models, general_beam.CASES[case])


METHODS = ['greedy', 'sample', 'gumbel', 'top3', 'top0.8']


@pytest.mark.parametrize('method', METHODS)
def test_sample_stats_match_jax(models, method):
    """Each sampling method with the JAX draws of the same step keys."""
    jcap, variables, pcap = models
    fc, att, am = inputs(B=3, seed=2)
    opt = {'sample_method': method, 'sample_n': 2, 'temperature': 0.7,
           'beam_size': 1, 'group_size': 1, 'decoding_constraint': 1}
    js, jst = jcap.sample_stats_jit(variables, *_jax_in(fc, att, am),
                                    jax.random.PRNGKey(6), opt)
    seq, st = pcap.sample_stats(*_torch(fc, att, am),
                                jax_draws(6, pcap.cfg.seq_length), opt)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    fin = np.isfinite(np.asarray(jst['lp_sum']))
    _close(st['lp_sum'].numpy()[fin], np.asarray(jst['lp_sum'])[fin],
           SUM_ATOL)


def test_diverse_sample_matches_jax(models):
    jcap, variables, pcap = models
    fc, att, am = inputs(B=3, seed=1)
    opt = {'sample_method': 'top3', 'group_size': 3,
           'diversity_lambda': 0.5, 'beam_size': 1, 'block_trigrams': 1}
    js, jlp = jcap.sample_jit(variables, *_jax_in(fc, att, am),
                              jax.random.PRNGKey(5), opt)
    seq, lp = pcap.sample(*_torch(fc, att, am),
                          jax_draws(5, pcap.cfg.seq_length + 2), opt)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    _close(lp.numpy(), jlp)


@pytest.mark.parametrize('config', ['aoa', 'lstm-res-fc', 'plain-head-bn1',
                                    'bn2-ff-scale2'])
def test_weight_bridge_round_trip(config):
    """Every JAX key lands once under its own name (kernels transposed),
    the port's tree comes back to the same JAX tree, and the parameters
    alone map both ways (the optimizer state's layout)."""
    opt = tiny_aoa_opt(**CONFIGS[config])
    _, variables, pcap = jax_and_port(opt=opt)
    cfg = config_from_opt(opt, V)
    flat = _flatten_tree(variables)
    sd = state_dict_from_jax(flat, cfg)
    assert set(sd) == set(paoa.AoACaptioner(cfg).state_dict())
    for key, value in flat.items():
        np.testing.assert_array_equal(
            sd[_harness_name(key)].numpy(),
            value.T if key.endswith('/kernel') else value)
    back = jax_from_state_dict(pcap.module.state_dict(), cfg)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    params = dict(pcap.module.named_parameters())
    jp = jax_from_state_dict(params, cfg, params_only=True)
    assert sorted(jp) == sorted(k for k in flat if k.startswith('params/'))
    assert set(state_dict_from_jax(jp, cfg, params_only=True)) == set(params)
    assert any(k.startswith('batch_stats/att_bn_in/')
               for k in back) == bool(cfg.use_bn)
    # the names as the JAX tree has them
    assert 'params/refiner/norm_out/a_2' in flat
    assert ('params/attention/norm/a_2' in flat) == (
        cfg.use_multi_head == 2)


def test_init_weights_follow_jax_init():
    """The port's own init: Dense U(+-1/sqrt(fan_in)), the embedding
    N(0, 1), the LSTM cells U(+-1/sqrt(rnn_size)), the LayerNorms 1 / 0."""
    from captioning_tpu_torch.models.api import setup
    cap = setup(tiny_aoa_opt(rnn_size=64, input_encoding_size=48,
                             vocab_size=400), device='cpu').init_params(
        torch.Generator().manual_seed(0))
    sd = cap.module.state_dict()
    bound = lambda name: sd[name].abs().max().item()
    assert abs(sd['embed.embedding'].std().item() - 1.0) < 0.05
    for name in ('att_lstm.ih.weight', 'att_lstm.hh.bias'):
        assert 0.9 / 8 < bound(name) <= 1 / 8
    assert 0.9 / 8 < bound('logit.weight') <= 1 / 8            # fan_in 64
    assert 0.9 / 8 < bound('refiner.attn_0.q.weight') <= 1 / 8
    assert bound('refiner.attn_2.aoa.weight') <= 1 / np.sqrt(128)
    assert torch.equal(sd['refiner.norm_out.a_2'], torch.ones(64))
    assert torch.equal(sd['attention.norm.b_2'], torch.zeros(64))
