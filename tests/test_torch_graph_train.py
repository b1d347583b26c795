"""The graphed train steps' programs on the CPU (``Trainer.xe_step_graphed``
/ ``sc_fused_step_graphed`` / ``sc_grad_step_graphed`` / ``struc_*``,
``engine.graphs.GraphTrainStep``), float32 at tiny widths:

* the step bodies read nothing on the host (``NoHostRead``), for every
  model key and step kind a graph captures; the optimizer's update runs
  outside the check, because torch.optim's CPU update reads its host step
  count by design (on the card the trainer's optimizer is capturable: its
  step count lives on the device, and the capture itself is the check,
  ``chip_smoke.py`` phase 13);
* the program route, through ``graphs.EagerRecorder`` (which replays the
  recorded closure eagerly), matches the JAX ``Trainer.xe_step`` and
  ``sc_fused_step`` over 3 steps: the first loss within 1e-5 relative, the
  trajectory and the parameters within 1e-4, the sequences identical;
* one cached program serves every learning rate and scheduled-sampling
  probability; a baked option, a flag or a new shape makes a new entry;
* the routes that stay eager say why and raise on the graphed entry;
* the transformer's train-mode step at a uniform ``t`` equals the per-row
  step ``_step_rows`` on one generator state, and JAX's train-mode
  recompute; scheduled sampling's draw equals ``torch.multinomial``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from captioning_tpu_torch.engine.graphs import EagerRecorder, GraphTrainStep
from captioning_tpu_torch.models import harness as pharness
from captioning_tpu_torch.models import transformer as ptransformer
from captioning_tpu_torch.models.api import setup
from captioning_tpu_torch.modules.trainer import Trainer
from captioning_tpu_torch.ops.cider_device import DeviceCiderD
from tests.torch_graph_util import NoHostRead
from tests.torch_port_util import (inputs, jax_and_port, jax_draws, tiny_opt,
                                   tiny_vocab, train_batch)
from tests.torch_rl_util import (B, N_SAMPLE, Both, check_trajectory, rl_opt,
                                 write_df)
from tests.torch_train_util import check_losses, check_opt_state


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def df(tmp_path_factory):
    return write_df(tmp_path_factory.mktemp('graph_train'))


def _trainer(model, seed=0, **kw):
    """A port trainer of ``model`` at the RL options, dropout on, from the
    port's own init."""
    opt = rl_opt(model, **dict(dict(drop_prob_lm=0.3, dropout=0.2), **kw))
    cap = setup(opt, tiny_vocab(), 'cpu').init_params(
        torch.Generator().manual_seed(seed))
    return Trainer(cap, opt)


def _batch(pcap):
    from tests.torch_rl_util import references
    fc, att, am = inputs(B)
    _, refs, ref_mask = references(pcap, fc, att, am)
    labels, masks = train_batch(B, N_SAMPLE)
    t = torch.from_numpy
    return dict(fc=t(fc), att=t(att), am=t(am), labels=t(labels),
                masks=t(masks), refs=t(refs), ref_mask=t(ref_mask))


def _calls(tr, x, scorer):
    """step kind -> (prepare() -> the arguments, the eager step): each
    kind's step as ``train_torch.py`` drives it, its host-side inputs
    made by ``prepare`` outside the check."""
    gen, gen_lm, noise = (torch.Generator().manual_seed(k)
                          for k in (1, 2, 3))
    fc, att, am = x['fc'], x['att'], x['am']

    def sc_grad():
        greedy, sampled = tr.sc_decode(fc, att, am, None, noise, gen)
        reward = scorer.self_critical_reward(greedy, sampled, x['refs'],
                                             x['ref_mask'])
        return (fc, att, am, sampled, reward, 1e-2, gen)

    def struc_grad():
        sampled = tr.struc_decode(fc, att, am, noise, gen)
        scores = scorer.score_grouped(sampled, x['refs'], x['ref_mask'],
                                      N_SAMPLE).float()
        return (fc, att, x['labels'], x['masks'], am, sampled, scores,
                torch.zeros(B), 1e-2, gen, gen_lm)

    return {
        'xe': (lambda: (fc, att, x['labels'], x['masks'], am, 1e-2, 0.25,
                        gen), tr.xe_step),
        'sc_fused': (lambda: (fc, att, am, x['refs'], x['ref_mask'], 1e-2,
                              None, noise, gen, scorer), tr.sc_fused_step),
        'sc_grad': (sc_grad, tr.sc_grad_step),
        'struc_fused': (lambda: (fc, att, x['labels'], x['masks'], am,
                                 x['refs'], x['ref_mask'], 1e-2, noise, gen,
                                 gen_lm, scorer), tr.struc_fused_step),
        'struc_grad': (struc_grad, tr.struc_grad_step),
    }


# (step kind, model): every model key a body is held for
BODIES = ([('xe', m) for m in ('updown', 'stackatt', 'newfc',
                               'transformer', 'att2in', 'show_tell')]
          + [(k, m) for k in ('sc_fused', 'sc_grad')
             for m in ('updown', 'transformer')]
          + [('struc_fused', 'updown'), ('struc_fused', 'transformer'),
             ('struc_grad', 'updown')])


@pytest.mark.parametrize('kind,model', BODIES)
def test_step_body_reads_nothing_on_the_host(kind, model, df):
    """After one step (host constants, such as the rounded attention
    scales, are made then, once, as the graph's warm-up step makes them),
    a step's forward, loss, backward and clip read no tensor on the
    host."""
    tr = _trainer(model)
    assert tr.graph_route(kind) == ''
    scorer = DeviceCiderD(df[1], df[2], device='cpu')
    prepare, step = _calls(tr, _batch(tr.captioner), scorer)[kind]
    step(*prepare())
    update = tr.optimizer.step

    def outside(*a, **k):
        with _disable_current_modes():
            return update(*a, **k)

    tr.optimizer.step = outside
    args = prepare()
    before = {n: p.detach().clone() for n, p in tr.named_params.items()}
    with NoHostRead():
        out = step(*args)
    assert torch.isfinite(out['loss'])
    # the update ran: a graph that captured it steps the parameters
    assert any(not torch.equal(before[n], p.detach())
               for n, p in tr.named_params.items())


class _Noise:
    """One ``draw`` object across steps (a graph entry is keyed by the
    objects it draws from), returning the JAX noise of the current step."""

    def __init__(self, L):
        self.L = L
        self.draw = None

    def seed(self, step):
        self.draw = jax_draws(step, self.L)

    def __call__(self, kind, t, shape):
        return self.draw(kind, t, shape)


def _grads(pt):
    """The port's gradients of the last step, in the JAX layout."""
    from captioning_tpu_torch.utils.weights import jax_from_state_dict
    return jax_from_state_dict({n: p.grad.clone()
                                for n, p in pt.named_params.items()},
                               pt.captioner.cfg, True)


def _params_close(variables, pt, grads, atol=1e-4):
    """Every parameter of the port's trainer ``pt`` within ``atol`` of the
    JAX ``variables``, but the elements whose gradient was 0 up to
    rounding at some step (at most 1e-6 of the step's largest gradient, as
    ``chip_smoke.py`` holds them; ``grads``: each step's ``_grads``).
    Adam divides a gradient by its own magnitude, so there it scales each
    framework's rounding noise into a step of the learning rate's size:
    the K biases of attention (a bias added to every score of a softmax
    row has an exact gradient of 0) and elements whose inputs are ~0."""
    from captioning_tpu.utils.misc import _flatten_tree
    want = _flatten_tree(jax.tree.map(np.asarray,
                                      {'params': variables['params']}))
    got = dict(_flatten_tree(pt.captioner.jax_variables()))
    assert want and set(want) <= set(got)
    checked = 0
    for key, w in want.items():
        keep = np.ones(w.shape, bool)
        for g in grads:
            scale = max(float(np.abs(x).max()) for x in g.values())
            keep &= np.abs(g[key]) > 1e-6 * scale
        np.testing.assert_allclose(got[key][keep], w[keep], atol=atol,
                                   rtol=0, err_msg=key)
        checked += int(keep.sum())
    # the rule leaves out a small share
    assert checked > 0.9 * sum(w.size for w in want.values())


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_graphed_xe_step_matches_jax(model):
    from captioning_tpu.modules.trainer import Trainer as JaxTrainer
    from tests.torch_train_util import model_opt
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
        grads.append(_grads(pt))
    check_losses(want, got)
    _params_close(variables, pt, grads)
    check_opt_state(state, pt)
    assert len(pt._graphs) == 1


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_graphed_sc_fused_step_matches_jax(df, model):
    both = Both(model, df[0])
    jt, pt = both.jt, both.pt
    pt.graph_recorder = EagerRecorder
    jin = both.jargs('fc', 'att', 'am')
    pin = both.pargs('fc', 'att', 'am')
    refs_j, refs_p = both.jargs('refs', 'ref_mask'), both.pargs('refs',
                                                               'ref_mask')
    noise, gen = _Noise(both.L), torch.Generator()
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
        grads.append(_grads(pt))
    check_trajectory(want, got)
    np.testing.assert_allclose(got_r, want_r, atol=1e-5, rtol=0)
    _params_close(variables, pt, grads)
    check_opt_state(state, pt)
    assert len(pt._graphs) == 1


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_graphed_sc_grad_step_equals_the_eager_one(df, model):
    """sc_decode, then the grad step eagerly and through the program, from
    one init and generator state: the same losses and parameters."""
    trainers = [_trainer(model), _trainer(model)]
    trainers[1].graph_recorder = EagerRecorder
    scorer = DeviceCiderD(df[1], df[2], device='cpu')
    x = _batch(trainers[0].captioner)
    losses = []
    for tr, graphed in zip(trainers, (False, True)):
        prepare, step = _calls(tr, x, scorer)['sc_grad']
        step = tr.sc_grad_step_graphed if graphed else step
        losses.append([float(step(*prepare())['loss']) for _ in range(3)])
    assert losses[0] == losses[1]
    for n, p in trainers[0].named_params.items():
        assert torch.equal(p, trainers[1].named_params[n]), n
    assert len(trainers[1]._graphs) == 1


def test_one_program_serves_every_lr_and_ss_prob():
    """Three steps at three learning rates and scheduled-sampling
    probabilities through one cached program equal three eager steps."""
    x = _batch(_trainer('updown').captioner)
    trainers = [_trainer('updown'), _trainer('updown')]
    trainers[1].graph_recorder = EagerRecorder
    args = (x['fc'], x['att'], x['labels'], x['masks'], x['am'])
    losses = []
    gens = [torch.Generator().manual_seed(5) for _ in trainers]
    for tr, gen, graphed in zip(trainers, gens, (False, True)):
        step = tr.xe_step_graphed if graphed else tr.xe_step
        losses.append([float(step(*args, lr, ss, gen)['loss'])
                       for lr, ss in ((1e-2, 0.0), (5e-3, 0.5),
                                      (2e-2, 1.0))])
    assert losses[0] == losses[1]
    for n, p in trainers[0].named_params.items():
        assert torch.equal(p, trainers[1].named_params[n]), n
    (entry,) = trainers[1]._graphs.values()
    assert entry.replays == 2
    # the rates reached the optimizer: a fourth step at rate 0 moves nothing
    before = {n: p.detach().clone()
              for n, p in trainers[1].named_params.items()}
    trainers[1].xe_step_graphed(*args, 0.0, 0.0, gens[1])
    assert entry.replays == 3
    assert all(torch.equal(before[n], p)
               for n, p in trainers[1].named_params.items())


def test_a_baked_option_or_a_new_shape_makes_a_new_entry(df):
    tr = _trainer('updown')
    tr.graph_recorder = EagerRecorder
    x = _batch(tr.captioner)
    gen = torch.Generator().manual_seed(0)

    def xe(n=B, **kw):
        tr.xe_step_graphed(x['fc'][:n], x['att'][:n], x['labels'][:n],
                           x['masks'][:n], x['am'][:n], 1e-2, 0.0, gen, **kw)
        return len(tr._graphs)

    assert xe() == 1
    assert xe() == 1                      # the same shapes: a replay
    assert xe(n=2) == 2                   # a last partial batch
    assert xe(drop_worst_flag=True) == 3
    tr.opt.label_smoothing = 0.1
    assert xe() == 4
    tr.opt.label_smoothing = 0
    assert xe() == 4
    scorer = DeviceCiderD(df[1], df[2], device='cpu')
    noise = torch.Generator().manual_seed(1)

    def sc():
        tr.sc_fused_step_graphed(x['fc'], x['att'], x['am'], x['refs'],
                                 x['ref_mask'], 1e-2, None, noise, gen,
                                 scorer)
        return len(tr._graphs)

    assert sc() == 5
    tr.opt.cider_reward_weight = 0.5
    assert sc() == 6
    assert sc() == 6
    # another generator object is another graph's
    gen = torch.Generator().manual_seed(0)
    assert xe() == 7


def test_graph_train_step_returns_fresh_outputs():
    """The first step comes from making the entry, each later one from a
    replay into the same static tensors, returned as clones."""
    w = torch.zeros(3)

    def body(x, none):
        assert none is None
        w.add_(x)
        return {'w': w * 1.0, 'x2': x * 2}

    entry = GraphTrainStep(body, {'x': torch.ones(3), 'none': None}, (),
                           EagerRecorder())
    assert torch.equal(entry.first['w'], torch.ones(3))
    out = entry({'x': torch.full((3,), 2.0), 'none': None})
    assert torch.equal(out['w'], torch.full((3,), 3.0))
    assert torch.equal(out['x2'], torch.full((3,), 4.0))
    assert out['w'] is not entry.outputs['w']
    assert entry.replays == 1 and entry.launches() == {}


@pytest.mark.parametrize('kind,opt_kw,why', [
    ('xe', {'optim': 'sgdmom'}, 'torch.optim.SGD'),
    ('sc_grad', {'optim': 'adagrad'}, 'torch.optim.Adagrad'),
    ('sc_fused', {'sc_beam_size': 2}, 'beam-search greedy baseline'),
    ('struc_fused', {'self_cider_reward_weight': 0.5}, 'eigvalsh'),
])
def test_an_eager_route_names_its_reason(kind, opt_kw, why, df):
    tr = _trainer('updown', **opt_kw)
    assert why in tr.graph_route(kind)
    tr.graph_recorder = EagerRecorder
    scorer = DeviceCiderD(df[1], df[2], device='cpu')
    prepare, _ = _calls(tr, _batch(tr.captioner), scorer)[kind]
    with pytest.raises(ValueError, match='no graphed %s step' % kind):
        getattr(tr, '%s_step_graphed' % kind)(*prepare())
    for other in ('adam', 'adamw', 'rmsprop'):
        assert _trainer('updown', optim=other).graph_route('xe') == ''


def _transformer(dropout):
    opt = tiny_opt(drop_prob_lm=dropout, dropout=dropout)
    return setup(opt, tiny_vocab(), 'cpu').init_params(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize('sample_n', [1, 3])
def test_uniform_train_step_equals_step_rows(sample_n):
    """Step by step from one generator state, the uniform-t train step and
    the per-row step give the same logprobs, caches and generator state
    (the same dropout masks in the same order)."""
    cap = _transformer(0.3)
    module = cap.module
    fc, att, am = (torch.from_numpy(a) for a in inputs(3))
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    with torch.no_grad():
        # sample_n rows share each image's memory row, as in sampling
        feats = module.prepare_feature(fc, att, am, gens[0])
        gens[1].set_state(gens[0].get_state())
        N = 3 * sample_n
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
            assert states[0]['t'] == t + 1 and torch.equal(
                states[1]['t'], torch.full((N,), t + 1))
            assert torch.equal(gens[0].get_state(), gens[1].get_state())
            it = a.argmax(-1)


def test_uniform_train_step_matches_jax_and_skips_the_row_step(monkeypatch):
    """The train-mode recompute (dropout 0) over a sequence equals the JAX
    train-mode ``scan_logprobs``, and never takes ``_step_rows``."""
    from captioning_tpu.engine import decoding as jdecoding
    opt = tiny_opt()
    jcap, variables, pcap = jax_and_port(opt=opt)
    fc, att, am = inputs(3)
    seq = np.random.RandomState(2).randint(1, 20, (6, 8)).astype('int64')
    seq[0, 3:] = 0
    dm = jcap.bind(variables, train=True)
    want = jdecoding.scan_logprobs(dm, jnp.asarray(fc), jnp.asarray(att),
                                   jnp.asarray(am), jnp.asarray(seq),
                                   jax.random.PRNGKey(0), sample_n=2)

    def refuse(*a, **k):
        raise AssertionError('the train-mode step took _step_rows')

    monkeypatch.setattr(ptransformer.TransformerCaptioner, '_step_rows',
                        refuse)
    got = pcap.scan_logprobs(*(torch.from_numpy(a) for a in (fc, att, am)),
                             torch.from_numpy(seq), torch.Generator(), 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_scheduled_sample_draws_multinomials_token(seed):
    """The written-out draw picks ``torch.multinomial``'s token from the
    same generator state, and leaves the generator where it leaves it."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(7, 30, generator=g) * 3, -1)
    it = torch.arange(7)
    a, b = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(
        seed)
    got = pharness.scheduled_sample(it, lp, 1.0, a)
    torch.rand(7, generator=b)
    want = torch.multinomial(lp.exp(), 1, generator=b)[:, 0]
    assert torch.equal(got, want)
    assert torch.equal(a.get_state(), b.get_state())
