"""The BERT captioner (``captioning_tpu_torch/models/bert_cap.py``) and
the Meshed-Memory Transformer (``models/m2.py``) against the JAX package's
modules on the same weights and inputs, float32 on the CPU, at tiny
widths (2 + 2 layers, d_model 32 in 4 heads, d_ff 48, 5 regions, M2's 40
memory slots), each case run for both models:

* ``prepare_feature`` (bert's memory, M2's levels) at ``use_bn`` 0 / 1 /
  2; atol 1e-5;
* steps at a uniform ``t`` (B1's twin; plain and through the beam
  ancestry, with reorders between the steps) and at per-row ``t``: the
  log-probs and logits, the caches (the port's merged lanes ``[N, Tp, D]``
  against JAX's ``[N, h, T, dk]``) and the ancestry; atol 1e-5;
* teacher forcing at ``seq_per_img`` 1 and 5; atol 1e-5;
* the decodes: greedy, beam 3 on the fast and the general body, a diverse
  beam, sampling with JAX's noise handed to the port: tokens identical,
  sums within 1e-4;
* the weight bridge both ways, ``batch_stats`` included, exact; the
  port's own init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.utils.misc import _flatten_tree
from captioning_tpu_torch.models.api import setup
from captioning_tpu_torch.models.config import config_from_opt
from captioning_tpu_torch.utils.weights import (_harness_name,
                                                 jax_from_state_dict,
                                                 state_dict_from_jax)
from tests import test_torch_general_beam as general_beam
from tests.torch_port_util import (V, bad_endings_vocab, inputs, jax_and_port,
                                   jax_draws, tiny_opt)

ATOL, SUM_ATOL = 1e-5, 1e-4
MODELS = ['bert', 'm2transformer']
H = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


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


def _prepare(jcap, variables, pm, fc, att, am):
    jm = jcap.module
    want = jm.apply(variables, *map(jnp.asarray, (fc, att, am)), False,
                    method=type(jm).prepare_feature)
    got = pm.prepare_feature(*map(torch.from_numpy, (fc, att, am)))
    return want, got


@pytest.mark.parametrize('use_bn', [0, 1, 2])
@pytest.mark.parametrize('model', MODELS)
def test_prepare_feature_matches_jax(model, use_bn):
    jcap, variables, pcap = jax_and_port(caption_model=model, use_bn=use_bn)
    if use_bn:
        _randomise_bn(variables)
        pcap.load_jax_variables(variables)
    want, got = _prepare(jcap, variables, pcap.module, *inputs())
    assert set(got) == set(want)
    key = 'memory' if model == 'bert' else 'levels'
    assert tuple(got[key].shape) == tuple(want[key].shape)
    _close(got[key], want[key])


def _caches_close(st_p, st_j, N_dec=2):
    """The port's merged-lane caches [N, Tp, D] against JAX's [N, h, T,
    dk] over JAX's T slots."""
    for i in range(N_dec):
        for kv in 'kv':
            key = '%s%d' % (kv, i)
            want = np.asarray(st_j[key])
            N, h, T, dk = want.shape
            got = st_p[key][:, :T].reshape(N, T, h, dk).permute(0, 2, 1, 3)
            _close(got, want)


@pytest.mark.parametrize('bw', [0, 3])
@pytest.mark.parametrize('model', MODELS)
def test_steps_match_jax(model, bw):
    """Four steps at a uniform ``t`` (the eval step, B1's twin), with
    reorders within the beam blocks between them; then three at per-row
    positions (the staggered groups of diverse decoding, one row near the
    end of the cache).  Log-probs and logits, caches, ``t`` and ``anc`` as
    the JAX step's."""
    jcap, variables, pcap = jax_and_port(caption_model=model)
    jm, pm = jcap.module, pcap.module
    B = 2
    fc, att, am = inputs(B=B)
    feats_j, feats_p = _prepare(jcap, variables, pm, fc, att, am)
    N = B * max(bw, 1)
    rng = np.random.RandomState(0)
    for uniform in (True, False):
        st_j, st_p = jm.init_state(N), pm.init_state(N)
        Tp, T = st_p['k0'].shape[1], st_j['k0'].shape[2]
        if not uniform:
            t0 = np.array([0, 3, 1, T - 3, 2, 5][:N], 'int32')
            st_j = dict(st_j, t=jnp.asarray(t0))
            st_p = dict(st_p, t=torch.from_numpy(t0).long())
        if bw:
            anc = np.broadcast_to((np.arange(N) % bw)[:, None],
                                  (N, Tp)).astype('int32')
            st_j = dict(st_j, anc=jnp.asarray(anc[:, :T]))
            st_p = dict(st_p, anc=torch.from_numpy(anc.copy()))
        for t in range(4 if uniform else 3):
            if bw and t:
                parent = (np.arange(N) // bw) * bw + rng.randint(0, bw, N)
                st_j = dict(st_j, anc=st_j['anc'][parent])
                st_p = dict(st_p, anc=st_p['anc'][torch.from_numpy(parent)])
            it = rng.randint(1, V + 1, N).astype('int32')
            for lsm in (False, True):
                # the uniform step writes its caches in place: the same
                # entries twice
                out_j, nst_j = jm.apply(variables, jnp.asarray(it), feats_j,
                                        st_j, False, lsm, uniform, bw,
                                        method=type(jm).step)
                out_p, nst_p = pm.step(torch.from_numpy(it).long(), feats_p,
                                       st_p, lsm, uniform, bw)
                assert out_p.dtype == torch.float32
                _close(out_p, out_j)
            st_j, st_p = nst_j, nst_p
            if uniform:
                assert st_p['t'] == int(st_j['t'][0])
            else:
                np.testing.assert_array_equal(st_p['t'].numpy(),
                                              np.asarray(st_j['t']))
            _caches_close(st_p, st_j)
            if bw:
                np.testing.assert_array_equal(st_p['anc'][:, :T].numpy(),
                                              np.asarray(st_j['anc']))


@pytest.mark.parametrize('spi', [1, 5])
@pytest.mark.parametrize('model', MODELS)
def test_forward_tf_matches_jax(model, spi):
    jcap, variables, pcap = jax_and_port(caption_model=model)
    B, T = 2, 7
    fc, att, am = inputs(B=B)
    seq = np.random.RandomState(2).randint(1, V + 1, (B, spi, T)).astype(
        'int32')
    seq[..., 0] = 0
    seq[0, 0, 4:] = 0              # an ended caption (eos then pads)
    want = jcap.forward_tf(variables, *map(jnp.asarray, (fc, att, seq, am)))
    got = pcap.forward_tf(torch.from_numpy(fc), torch.from_numpy(att),
                          torch.from_numpy(seq).long(), torch.from_numpy(am))
    assert tuple(got.shape) == tuple(want.shape) == (B * spi, T, V + 1)
    _close(got, want)


# one JAX captioner a model, its compiled programs reused across the cases
@pytest.fixture(scope='module', params=MODELS)
def models(request):
    return jax_and_port(seed=3, opt=tiny_opt(caption_model=request.param),
                        vocab=bad_endings_vocab())


def _jax_in(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_greedy_matches_jax(models):
    jcap, variables, pcap = models
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


def test_beam3_fast_body_matches_jax(models):
    jcap, variables, pcap = models
    fc, att, am = inputs(B=4, seed=5)
    opt = {'beam_size': 3, 'sample_n': 1, 'group_size': 1,
           'suppress_UNK': 1, 'length_penalty': 'wu_0.9'}
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
    gs, _, _ = pcap.sample_beam_graphed(*_torch(fc, att, am), None, opt)
    assert torch.equal(gs, ps)


@pytest.mark.parametrize('case', ['G1-general-unk-wu', 'G2-constraints'])
def test_general_and_diverse_beam_match_jax(models, case):
    """Beam 3 on the general body, and a diverse beam in 2 groups with the
    constraints (the per-row step), with the winner-logprob replay."""
    general_beam._check(*models, general_beam.CASES[case])


def test_sampling_matches_jax(models):
    """sample_n 2 by top-3 sampling with the JAX draws of the same step
    keys."""
    jcap, variables, pcap = models
    fc, att, am = inputs(B=3, seed=2)
    opt = {'sample_method': 'top3', 'sample_n': 2, 'temperature': 0.7,
           'beam_size': 1, 'group_size': 1}
    js, jst = jcap.sample_stats_jit(variables, *_jax_in(fc, att, am),
                                    jax.random.PRNGKey(6), opt)
    seq, st = pcap.sample_stats(*_torch(fc, att, am),
                                jax_draws(6, pcap.cfg.seq_length), opt)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(js))
    _close(st['lp_sum'], jst['lp_sum'], SUM_ATOL)


@pytest.mark.parametrize('model', MODELS)
def test_weight_bridge_round_trip(model):
    """Every JAX key lands once under its own name (kernels transposed),
    the port's tree comes back to the same JAX tree, and the parameters
    alone map both ways (the optimizer state's layout); use_bn 2, so the
    BatchNorm statistics go too."""
    opt = tiny_opt(caption_model=model, use_bn=2)
    _, variables, pcap = jax_and_port(opt=opt)
    cfg = config_from_opt(opt, V)
    flat = _flatten_tree(variables)
    sd = state_dict_from_jax(flat, cfg)
    assert set(sd) == set(type(pcap.module)(cfg).state_dict())
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
    assert 'batch_stats/att_bn_in/mean' in back
    if model == 'm2transformer':
        assert 'params/enc_self_1/mem_v' in flat
        assert 'params/dec_gates_1_0/kernel' in flat
    else:
        assert 'params/dec_cross_1/ln/scale' in flat
    # a key left over raises
    extra = dict(flat, **{'params/stray/kernel': np.zeros((2, 2), 'f4')})
    with pytest.raises(KeyError, match='not consumed'):
        state_dict_from_jax(extra, cfg)


@pytest.mark.parametrize('model', MODELS)
def test_init_weights_follow_jax_init(model):
    """The port's own init: Dense U(+-1/sqrt(fan_in)), the generator
    xavier-uniform, the embeddings N(0, 0.02), M2's memory slots N(0, 1/D)
    and N(0, 1/40), the LayerNorms 1 / 0."""
    cap = setup(tiny_opt(caption_model=model, d_model=64, d_ff=96,
                         vocab_size=400), device='cpu').init_params(
        torch.Generator().manual_seed(0))
    sd = cap.module.state_dict()
    bound = lambda name: sd[name].abs().max().item()
    assert abs(sd['word_embed'].std().item() - 0.02) < 0.002
    assert 0.9 / 8 < bound('dec_self_0.wq.weight') <= 1 / 8   # fan_in 64
    assert 0.9 / 8 < bound('dec_cross_1.wo.bias') <= 1 / 8
    xavier = np.sqrt(6.0 / (64 + 401))
    assert 0.9 * xavier < bound('generator.weight') <= xavier
    assert torch.equal(sd['dec_self_1.ln.scale'], torch.ones(64))
    assert torch.equal(sd['dec_self_1.ln.bias'], torch.zeros(64))
    if model == 'm2transformer':
        assert abs(sd['enc_self_0.mem_k'].std().item() - 1 / 8) < 0.01
        assert abs(sd['enc_self_1.mem_v'].std().item()
                   - 1 / np.sqrt(40)) < 0.02
        assert bound('dec_gates_0_1.weight') <= 1 / np.sqrt(128)
    else:
        assert abs(sd['pos_embed'].std().item() - 0.02) < 0.003
        assert tuple(sd['pos_embed'].shape) == (17, 64)
