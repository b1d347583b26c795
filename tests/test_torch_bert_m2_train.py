"""The train steps of the BERT captioner and the Meshed-Memory Transformer
on the CPU at tiny widths (``test_torch_bert_m2.py``'s), each case run for
both models:

* the XE and the fused SCST step through their graphed entries' program
  (``graphs.EagerRecorder``) against the JAX ``Trainer.xe_step`` and
  ``sc_fused_step`` over 3 steps, float32, dropout 0: the first loss
  within 1e-5 relative, the trajectory and the parameters within 1e-4,
  the optimizer state within 1e-6, the sequences identical (phase 13's
  rules in ``test_torch_graph_train.py``);
* each step body reads nothing on the host (``NoHostRead``), so a CUDA
  graph captures it;
* the uniform-t train step equals the per-row step on one generator
  state, bit for bit (the same dropout masks in the same order);
* one bf16 XE step with float32 masters against the JAX bf16 step, at
  the bounds of ``tests/torch_bf16_util.py``;
* the dropout sites: a train-mode ``forward_tf`` and a train-mode step
  draw as many masks as the JAX module's (counted as its
  ``jax.random.bernoulli`` calls while it is traced)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine.graphs import EagerRecorder
from captioning_tpu_torch.models import bert_cap as pbert
from captioning_tpu_torch.models import layers as players
from captioning_tpu_torch.models import m2 as pm2
from captioning_tpu_torch.models import transformer as ptransformer
from captioning_tpu_torch.modules.trainer import Trainer
from captioning_tpu_torch.ops.cider_device import DeviceCiderD
from tests import test_torch_graph_train as graph_train
from tests.torch_bf16_util import BF16, all_float32, check_bf16, xe_run
from tests.torch_port_util import inputs, jax_and_port, tiny_opt, train_batch
from tests.torch_rl_util import Both, check_trajectory, write_df
from tests.torch_train_util import check_losses, check_opt_state, model_opt

MODELS = ['bert', 'm2transformer']


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def df(tmp_path_factory):
    return write_df(tmp_path_factory.mktemp('bert_m2_train'))


@pytest.mark.parametrize('model', MODELS)
def test_graphed_xe_step_matches_jax(model):
    from captioning_tpu.modules.trainer import Trainer as JaxTrainer
    opt = model_opt(model)
    jcap, variables, pcap = jax_and_port(opt=opt)
    fc, att, am = inputs(4)
    labels, masks = train_batch(4, 5)
    jt, pt = JaxTrainer(jcap, opt), Trainer(pcap, opt)
    pt.graph_recorder = EagerRecorder
    state = jt.init_opt_state(variables)
    jargs = [jnp.asarray(a) for a in (fc, att, labels.astype('int32'), masks,
                                      am)]
    pargs = [torch.from_numpy(a) for a in (fc, att, labels, masks, am)]
    gen = torch.Generator()
    want, got, grads = [], [], []
    for step in range(3):
        variables, state, out = jt.xe_step(
            variables, state, *jargs, 1e-2, 0.0, jax.random.PRNGKey(step))
        want.append(float(out['loss']))
        got.append(float(pt.xe_step_graphed(
            *pargs, 1e-2, 0.0, gen.manual_seed(step))['loss']))
        grads.append(graph_train._grads(pt))
    check_losses(want, got)
    graph_train._params_close(variables, pt, grads)
    check_opt_state(state, pt)
    assert len(pt._graphs) == 1


@pytest.mark.parametrize('model', MODELS)
def test_graphed_sc_fused_step_matches_jax(df, model):
    both = Both(model, df[0])
    jt, pt = both.jt, both.pt
    pt.graph_recorder = EagerRecorder
    jin = both.jargs('fc', 'att', 'am')
    pin = both.pargs('fc', 'att', 'am')
    refs_j = both.jargs('refs', 'ref_mask')
    refs_p = both.pargs('refs', 'ref_mask')
    noise, gen = graph_train._Noise(both.L), torch.Generator()
    want, got, want_r, got_r, grads = [], [], [], [], []
    variables, state = both.variables, both.state
    for step in range(3):
        jrng, _ = both.draws(step)
        jg, js = jt.sc_decode(variables, *jin, jrng, jrng)
        variables, state, out = jt.sc_fused_step(
            variables, state, *jin, *refs_j, 1e-2, jrng, jrng, both.jsc)
        noise.seed(step)
        pout = pt.sc_fused_step_graphed(*pin, *refs_p, 1e-2, None, noise,
                                        gen.manual_seed(step), both.psc)
        np.testing.assert_array_equal(pout['greedy'].numpy(), np.asarray(jg))
        np.testing.assert_array_equal(pout['sampled'].numpy(),
                                      np.asarray(js))
        want.append(float(out['loss']))
        got.append(float(pout['loss']))
        want_r.append(float(out['reward']))
        got_r.append(float(pout['reward']))
        grads.append(graph_train._grads(pt))
    check_trajectory(want, got)
    np.testing.assert_allclose(got_r, want_r, atol=1e-5, rtol=0)
    graph_train._params_close(variables, pt, grads)
    check_opt_state(state, pt)
    assert len(pt._graphs) == 1


@pytest.mark.parametrize('kind', ['xe', 'sc_fused'])
@pytest.mark.parametrize('model', MODELS)
def test_step_body_reads_nothing_on_the_host(model, kind, df):
    graph_train.test_step_body_reads_nothing_on_the_host(kind, model, df)


@pytest.mark.parametrize('model', MODELS)
def test_uniform_train_step_equals_step_rows(model):
    """Step by step from one generator state, at dropout 0.3 and 3 rows an
    image, the uniform-t train step and the per-row step give the same
    logprobs, caches and generator state."""
    from captioning_tpu_torch.models.api import setup
    from tests.torch_port_util import tiny_vocab
    opt = tiny_opt(caption_model=model, drop_prob_lm=0.3, dropout=0.3)
    cap = setup(opt, tiny_vocab(), 'cpu').init_params(
        torch.Generator().manual_seed(0))
    module = cap.module
    fc, att, am = (torch.from_numpy(a) for a in inputs(3))
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    with torch.no_grad():
        feats = module.prepare_feature(fc, att, am, gens[0])
        gens[1].set_state(gens[0].get_state())
        N = 9
        states = [module.init_state(N), module.init_state(N)]
        it = torch.zeros(N, dtype=torch.long)
        for t in range(cap.cfg.seq_length):
            a, states[0] = module._step_train(it, feats, states[0], True,
                                              False, gens[0])
            b, states[1] = module._step_rows(it, feats, states[1], True, 0,
                                             False, gens[1])
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            for i in range(cap.cfg.N_dec):
                for kv in 'kv':
                    key = '%s%d' % (kv, i)
                    torch.testing.assert_close(states[0][key],
                                               states[1][key], rtol=0,
                                               atol=0)
            assert torch.equal(gens[0].get_state(), gens[1].get_state())
            it = a.argmax(-1)


@pytest.mark.parametrize('model', MODELS)
def test_bf16_xe_step_matches_jax(model):
    j16, (pl, pg, pt) = xe_run(model_opt(model, **BF16))
    j32, _ = xe_run(model_opt(model, grad_clip_value=0))
    assert pt.captioner.cfg.dtype == torch.bfloat16
    assert pl[0] == pytest.approx(j16[0][0], rel=1e-2)
    np.testing.assert_allclose(pl, j16[0], rtol=1e-2)
    assert pl[-1] < pl[0]
    check_bf16(pg, j16[1], j32[1], 'gradient')
    all_float32(pt)


@pytest.mark.parametrize('model', MODELS)
def test_dropout_sites_match_jax(model, monkeypatch):
    opt = tiny_opt(caption_model=model, drop_prob_lm=0.3, dropout=0.2)
    jcap, variables, pcap = jax_and_port(opt=opt)
    jm, pm = jcap.module, pcap.module
    fc, att, am = inputs(2)
    seq = np.array([[0], [3], [5], [0]], 'int32')   # 2 images x 2 captions
    it = np.array([1, 4, 2, 7], 'int32')
    feats_j = jm.apply(variables, *map(jnp.asarray, (fc, att, am)), False,
                       method=type(jm).prepare_feature)
    feats_j = jax.tree.map(lambda x: jnp.repeat(x, 2, 0), feats_j)

    jcount = [0]
    real = jax.random.bernoulli

    def counting(*a, **k):
        jcount[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(jax.random, 'bernoulli', counting)
    # the sites are Python calls: tracing the pass counts them
    jax.eval_shape(lambda v: jcap.forward_tf(
        v, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(seq),
        jnp.asarray(am), 0.0, jax.random.PRNGKey(0), train=True), variables)
    j_tf = jcount[0]
    jax.eval_shape(lambda v: jm.apply(
        v, jnp.asarray(it), feats_j, jm.init_state(4), True, True, True, 0,
        method=type(jm).step, rngs={'dropout': jax.random.PRNGKey(1)}),
        variables)
    j_step = jcount[0] - j_tf
    monkeypatch.setattr(jax.random, 'bernoulli', real)

    count = [0]
    real_dropout = players.dropout

    def counting_dropout(x, p, gen):
        if gen is not None and p > 0:
            count[0] += 1
        return real_dropout(x, p, gen)

    for mod in (players, ptransformer, pbert, pm2):
        monkeypatch.setattr(mod, 'dropout', counting_dropout)
    t = torch.from_numpy
    pcap.forward_tf(t(fc), t(att), t(seq).long(), t(am), train=True,
                    generator=torch.Generator().manual_seed(0))
    p_tf = count[0]
    feats_p = pm.prepare_feature(t(fc), t(att), t(am))
    feats_p = {k: v.repeat_interleave(2, 0) for k, v in feats_p.items()}
    pm.step(t(it).long(), feats_p, pm.init_state(4),
            gen=torch.Generator().manual_seed(1))
    p_step = count[0] - p_tf
    assert p_tf == j_tf > 0
    assert p_step == j_step > 0
