"""The port's RNN captioners (``models/harness.py``: UpDown, Att2in2,
Att2in, Att2all2, StackAtt / DenseAtt, NewFC / FC / LM, AdaAtt / AdaAttMO,
ShowTell with its LSTM and its GRU) against
the JAX modules on the same weights and inputs (float32 on the CPU, tiny
widths): prepare_feature, per-step log-probs and logits and the h / c state
over several steps, with the attention rows aligned to the queries and
block-shared by 5 beam lanes (repeated per lane for the models that read
them per row), and eval forward_tf at seq_per_img 5.  With use_pallas the JAX head runs the Pallas
kernel in interpret mode on aligned rows, and the port's head its twin.
atol 1e-5 (float32, summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.models.harness import SHARED_FEATS
from tests.torch_port_util import (NO_ATT_MODELS, RNN_MODELS, inputs,
                                   jax_and_port, tiny_opt, tiny_rnn_opt)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _prepare(jcap, pcap, variables, fc, att, am):
    m = jcap.module
    want = m.apply(variables, jnp.asarray(fc), jnp.asarray(att),
                   jnp.asarray(am), False, method=type(m).prepare_feature)
    got = pcap.module.prepare_feature(torch.from_numpy(fc),
                                      torch.from_numpy(att),
                                      torch.from_numpy(am))
    return want, got


@pytest.mark.parametrize('model', RNN_MODELS)
@pytest.mark.parametrize('use_bn', [0, 1, 2])
def test_prepare_feature_matches_jax(model, use_bn):
    jcap, variables, pcap = jax_and_port(opt=tiny_rnn_opt(model,
                                                          use_bn=use_bn))
    if use_bn:
        # non-trivial running stats and affine params for the eval branch
        rng = np.random.RandomState(1)
        for coll, name, f in (('batch_stats', 'mean', 0.5),
                              ('batch_stats', 'var', 1.0),
                              ('params', 'scale', 0.3),
                              ('params', 'bias', 0.3)):
            # (the FC family has no attention features and no BatchNorm)
            for bn in [b for b in ('att_bn_in', 'att_bn_out')
                       if b in variables.get(coll, {})]:
                a = variables[coll][bn][name]
                variables[coll][bn][name] = (
                    np.abs(rng.randn(*a.shape)) * f + (name == 'var')
                    ).astype('float32')
        pcap.load_jax_variables(variables)
    want, got = _prepare(jcap, pcap, variables, *inputs())
    assert set(got) == set(want)
    for key in ('fc_feats', 'att_feats', 'p_att_feats', 'att_masks'):
        if got[key] is None:
            # the FC family's and ShowTell's cores read no attention
            # features: the port carries none (the JAX tree carries the raw
            # ones, unread)
            assert model in NO_ATT_MODELS
            continue
        _close(got[key], want[key])


@pytest.mark.parametrize('model', RNN_MODELS)
@pytest.mark.parametrize('logit_layers', [1, 2])
@pytest.mark.parametrize('use_pallas', [0, 1])
@pytest.mark.parametrize('bw', [0, 5])
def test_steps_logprobs_and_state_match_jax(model, logit_layers, use_pallas,
                                            bw):
    """bw = 0: one attention row per query row; bw = 5: blocks of 5 query
    rows share one attention row (beam lanes), with a beam reorder inside
    the blocks between steps."""
    _check_steps(tiny_rnn_opt(model, logit_layers=logit_layers,
                              use_pallas=use_pallas), bw)


def _check_steps(opt, bw):
    model = opt.caption_model
    jcap, variables, pcap = jax_and_port(opt=opt)
    jm, pm = jcap.module, pcap.module
    B = 3
    N = B * max(bw, 1)
    feats_j, feats_p = _prepare(jcap, pcap, variables, *inputs(B=B))
    if bw and model not in SHARED_FEATS:
        # these cores read one feats row per query row: the engine
        # repeats the feats per beam lane
        feats_j = jax.tree.map(lambda v: jnp.repeat(v, bw, 0), feats_j)
        feats_p = {k: v if v is None else v.repeat_interleave(bw, 0)
                   for k, v in feats_p.items()}
    st_j, st_p = jm.init_state(N), pm.init_state(N)
    assert tuple(st_p['h'].shape) == tuple(st_j['h'].shape)
    rng = np.random.RandomState(0)
    for t in range(3):
        if bw and t:
            # rows inherit a parent within their block
            parent = (np.arange(N) // bw) * bw + rng.randint(0, bw, N)
            st_j = {k: v[parent] for k, v in st_j.items()}
            st_p = dict(st_p, h=st_p['h'][torch.from_numpy(parent)],
                        c=st_p['c'][torch.from_numpy(parent)])
        it = rng.randint(0, 30, N).astype('int32')
        for lsm in (False, True):
            out_j, nst_j = jm.apply(variables, jnp.asarray(it), feats_j, st_j,
                                    False, lsm, True, bw,
                                    method=type(jm).step)
            out_p, nst_p = pm.step(torch.from_numpy(it).long(), feats_p,
                                   st_p, lsm, True, bw)
            assert out_p.dtype == torch.float32
            _close(out_p, out_j)
        st_j, st_p = nst_j, nst_p
        assert st_p['t'] == int(st_j['t'][0])
        _close(st_p['h'], st_j['h'])
        _close(st_p['c'], st_j['c'])


@pytest.mark.parametrize('model', RNN_MODELS)
@pytest.mark.parametrize('logit_layers', [1, 2])
@pytest.mark.parametrize('use_pallas', [0, 1])
def test_forward_tf_matches_jax(model, logit_layers, use_pallas):
    """Teacher forcing over labels [B, seq_per_img, T] (the eval_split
    call): 5 captions per image share the image's attention row (or get
    one each, for the models that read the feats per row)."""
    _check_forward_tf(tiny_rnn_opt(model, logit_layers=logit_layers,
                                   use_pallas=use_pallas))


@pytest.mark.parametrize('model', ['adaatt', 'adaattmo'])
@pytest.mark.parametrize('num_layers', [1, 3])
def test_adaatt_depths_match_jax(model, num_layers):
    """AdaAtt at one layer (the sentinel gate reads the word and the image:
    r_w2h, r_v2h) and at three (r_i2h; i2h_0, i2h_1 between the layers),
    beside the two-layer cases above: step log-probs and state, per query
    row and per beam lane, and teacher forcing."""
    opt = tiny_rnn_opt(model, num_layers=num_layers)
    for bw in (0, 5):
        _check_steps(opt, bw)
    _check_forward_tf(opt)


def _check_forward_tf(opt):
    jcap, variables, pcap = jax_and_port(opt=opt)
    B, S, T = 2, 5, 6
    fc, att, am = inputs(B=B)
    rng = np.random.RandomState(2)
    seq = rng.randint(1, 30, (B, S, T)).astype('int32')
    seq[..., 0] = 0
    seq[0, 1, 3:] = 0                  # an ended caption (eos then pads)
    want = jcap.forward_tf(variables, jnp.asarray(fc), jnp.asarray(att),
                           jnp.asarray(seq), jnp.asarray(am))
    got = pcap.forward_tf(torch.from_numpy(fc), torch.from_numpy(att),
                          torch.from_numpy(seq).long(), torch.from_numpy(am))
    assert tuple(got.shape) == tuple(want.shape) == (B * S, T, 30)
    _close(got, want)


@pytest.mark.parametrize('model', ['bert', 'm2transformer'])
def test_bert_and_m2_build(model):
    """bert and m2transformer build on the CPU and decode a step; on
    'cuda' without a GPU they raise, as every key does."""
    from captioning_tpu_torch.models.api import setup
    cap = setup(tiny_opt(caption_model=model), device='cpu').init_params(
        torch.Generator().manual_seed(0))
    assert cap.module.cfg.caption_model == model
    fc, att, am = (torch.from_numpy(a) for a in inputs(B=2))
    seq, _ = cap.sample_stats(fc, att, am, None, {'sample_method': 'greedy'})
    assert tuple(seq.shape) == (2, cap.cfg.seq_length)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            setup(tiny_opt(caption_model=model), device='cuda')


@pytest.mark.parametrize('model,kw', [('show_tell', {}),
                                      ('show_tell', {'rnn_type': 'gru'}),
                                      ('att2in', {}), ('aoa', {})])
def test_last_rnn_keys_build(model, kw):
    """show_tell (LSTM and GRU), att2in and aoa build on the CPU; on
    'cuda' without a GPU they raise, as every key does."""
    from captioning_tpu_torch.models.api import setup
    cap = setup(tiny_rnn_opt(model, vocab_size=29, **kw),
                device='cpu').init_params(torch.Generator().manual_seed(0))
    assert cap.module.cfg.caption_model == model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            setup(tiny_rnn_opt(model, vocab_size=29, **kw), device='cuda')


def test_init_weights_follow_jax_init():
    """The port's own init: Dense U(+-1/sqrt(fan_in)), the embedding
    N(0, 1), the LSTM cells U(+-1/sqrt(rnn_size))."""
    from captioning_tpu_torch.models.api import setup
    cap = setup(tiny_rnn_opt('updown', rnn_size=64, input_encoding_size=48,
                             vocab_size=400), device='cpu').init_params(
        torch.Generator().manual_seed(0))
    sd = cap.module.state_dict()
    bound = lambda name: sd[name].abs().max().item()
    assert abs(sd['embed.embedding'].std().item() - 1.0) < 0.05
    for name in ('core.att_lstm.ih.weight', 'core.lang_lstm.hh.bias'):
        assert 0.9 / 8 < bound(name) <= 1 / 8
    assert 0.9 / 8 < bound('logit.weight') <= 1 / 8            # fan_in 64
    assert bound('core.attention.alpha_net.weight') <= 1 / np.sqrt(12)


@pytest.mark.parametrize('model', RNN_MODELS)
@pytest.mark.parametrize('use_bn,use_pallas', [(0, 0), (2, 1)])
def test_bf16_state_stays_bf16(model, use_bn, use_pallas):
    """h and c live in the compute dtype across steps, as the JAX cells
    keep them (a cell that upcast would round differently); the log-probs
    are float32.  With use_bn 2 the BatchNorm hands the head float32
    features, as in the JAX model."""
    from captioning_tpu_torch.models.api import setup
    cap = setup(tiny_rnn_opt(model, compute_dtype='bfloat16', use_bn=use_bn,
                             use_pallas=use_pallas), device='cpu').init_params(
        torch.Generator().manual_seed(0))
    pm = cap.module
    fc, att, am = (torch.from_numpy(a) for a in inputs(B=2))
    feats = pm.prepare_feature(fc, att, am)
    if feats['att_feats'] is not None:
        # att2in attends over the raw regions, in the input's dtype
        assert feats['att_feats'].dtype == (
            torch.float32 if use_bn == 2 or model == 'att2in'
            else torch.bfloat16)
    for n in (2, 10):                # aligned rows; 5 rows per att row
        if n > 2 and model not in SHARED_FEATS:
            # these cores read one feats row per query row
            feats = {k: v if v is None else v.repeat_interleave(5, 0)
                     for k, v in feats.items()}
        st = pm.init_state(n)
        for t in range(2):
            lp, st = pm.step(torch.full((n,), t + 1), feats, st)
            assert st['h'].dtype == st['c'].dtype == torch.bfloat16
            assert lp.dtype == torch.float32
            assert bool(torch.isfinite(lp).all())
