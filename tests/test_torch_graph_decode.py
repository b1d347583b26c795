"""The graph decodes' programs on the CPU (``engine.decoding.StepProgram``,
``engine.graphs``, ``Captioner.sample_beam_graphed`` /
``sample_stats_graphed``): the per-step body reads no tensor on the host
and keeps every carried tensor at its address; the restructured decode
gives JAX's ``sample_beam_jit(..., want_logps=False)`` / ``sample_stats_jit``
tokens (exact), pools and sums (1e-5) with the same exit step; and the
graph cache's plumbing, through ``graphs.EagerRecorder`` (a recorder that
replays the recorded closures eagerly), returns fresh outputs and keys
its entries by the options and shapes.  The CUDA graphs themselves run
on the card (``chip_smoke.py`` phase 12)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine import decoding
from captioning_tpu_torch.engine.graphs import EagerRecorder, GraphDecode
from captioning_tpu_torch.models.api import setup
from captioning_tpu_torch.ops import _build
from captioning_tpu_torch.utils import eval_utils
from tests.torch_graph_util import NoHostRead
from tests.torch_port_util import (inputs, jax_and_port, tiny_opt,
                                   tiny_rnn_opt, tiny_vocab)

SUMS_ATOL = 1e-5
BEAM = {'beam_size': 3, 'sample_n': 1, 'group_size': 1, 'suppress_UNK': 1}
GREEDY = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}
MODELS = {'transformer': tiny_opt, 'updown': lambda: tiny_rnn_opt('updown'),
          'newfc': lambda: tiny_rnn_opt('newfc'),
          'stackatt': lambda: tiny_rnn_opt('stackatt')}
# the models held against JAX
PARITY = ('newfc', 'transformer', 'updown')
# (model, program): the transformer's fused beam, UpDown's plain-step beam
# (B3, B6), NewFC's beam (per-lane feats, the FC seeding, B5), StackAtt's
# (B3 twice and B5 three times a step), and the greedy stats loop on the
# fused (transformer) and plain (UpDown) routes
BODIES = [('transformer', 'beam'), ('updown', 'beam'), ('newfc', 'beam'),
          ('stackatt', 'beam'), ('transformer', 'greedy'),
          ('updown', 'greedy')]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _captioner(model, seed=0):
    return setup(MODELS[model](), tiny_vocab(), 'cpu').init_params(
        torch.Generator().manual_seed(seed))


def _program(cap, kind, opt=None):
    if kind == 'beam':
        return decoding.beam_program(cap.bind(), dict(BEAM, **(opt or {})))
    return decoding.sample_program(cap.bind(), dict(GREEDY, **(opt or {})))


def _tensors(tree, prefix=''):
    """{path: tensor} of a carry (the model state and feats included)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tensors(v, prefix + k + '.'))
        elif torch.is_tensor(v):
            out[prefix + k] = v
    return out


@pytest.mark.parametrize('model,kind', BODIES)
def test_step_body_reads_nothing_on_the_host(model, kind):
    """After one warm-up decode (as ``GraphDecode`` runs before it
    captures: host constants such as the rounded attention scales are
    made then, once), no step body reads a tensor on the host."""
    cap = _captioner(model)
    prog = _program(cap, kind, {'length_penalty': 'wu_0.9'}
                    if kind == 'beam' else None)
    with torch.inference_mode():
        decoding.run_eager(prog, *_torch(*inputs(B=3, seed=0)))
        carry = prog.setup(*_torch(*inputs(B=3, seed=1)))
        with NoHostRead():
            for t in range(prog.steps):
                prog.body(carry, t)
    assert carry['go'].dim() == 0 and carry['go'].dtype == torch.bool


@pytest.mark.parametrize('model,kind', BODIES)
def test_carried_tensors_keep_their_addresses(model, kind):
    cap = _captioner(model)
    prog = _program(cap, kind)
    with torch.inference_mode():
        carry = prog.setup(*_torch(*inputs(B=3, seed=2)))
        ptrs = {k: v.data_ptr() for k, v in _tensors(carry).items()}
        seen = dict(ptrs)
        for t in range(prog.steps):
            prog.body(carry, t)
            now = {k: v.data_ptr() for k, v in _tensors(carry).items()}
            assert now == ptrs, t
    # the state's buffers are among them (the caches, or h / c)
    assert any(k.startswith('state.') for k in seen)


def _counting_bind(jcap, calls):
    """``jcap.bind`` with every model step counted while the compiled
    decode runs (a debug callback inside the program)."""
    bind = jcap.bind

    def counted(fn):
        def step(*a, **kw):
            jax.debug.callback(lambda: calls.append(1))
            return fn(*a, **kw)
        return step

    def counting(variables, train=False):
        dm = bind(variables, train)
        repl = {'step': counted(dm.step)}
        if dm.step_topk is not None:
            repl['step_topk'] = counted(dm.step_topk)
        return dataclasses.replace(dm, **repl)
    return counting


@pytest.fixture(scope='module', params=PARITY)
def models(request):
    # captions end early, so the exact early exit fires
    return (request.param,) + jax_and_port(seed=3, eos_boost=4.0,
                                           opt=MODELS[request.param]())


@pytest.mark.parametrize('kind', ['beam', 'greedy'])
def test_graph_route_matches_jax(models, kind, monkeypatch):
    model, jcap, variables, pcap = models
    fc, att, am = inputs(B=4, seed=5)
    jargs = (variables, jnp.asarray(fc), jnp.asarray(att), jnp.asarray(am),
             jax.random.PRNGKey(1))
    calls = []
    monkeypatch.setattr(jcap, 'bind', _counting_bind(jcap, calls))
    jcap._jit_cache.clear()
    pcap.graph_recorder = EagerRecorder
    pcap._graph_cache.clear()
    if kind == 'beam':
        opt = dict(BEAM, length_penalty='wu_0.9')
        js, jst, jdone = jcap.sample_beam_jit(*jargs, opt, want_logps=False)
        ps, pst, pdone = pcap.sample_beam_graphed(*_torch(fc, att, am), None,
                                                  opt)
        np.testing.assert_array_equal(pdone['seq'].numpy(),
                                      np.asarray(jdone['seq']))
        for key in ('ent_sum', 'lp_sum'):
            np.testing.assert_allclose(pdone[key].numpy(),
                                       np.asarray(jdone[key]),
                                       atol=SUMS_ATOL, rtol=0)
        # the pool scores carry the -1000 a finished lane takes: float32's
        # relative rounding at their magnitude
        for key in ('p', 'unaug_p'):
            np.testing.assert_allclose(pdone[key].numpy(),
                                       np.asarray(jdone[key]),
                                       atol=SUMS_ATOL, rtol=1e-6)
    else:
        js, jst = jcap.sample_stats_jit(*jargs, GREEDY)
        ps, pst = pcap.sample_stats_graphed(*_torch(fc, att, am), None,
                                            GREEDY)
    jax.effects_barrier()
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    for key in ('ent_sum', 'lp_sum'):
        np.testing.assert_allclose(pst[key].numpy(), np.asarray(jst[key]),
                                   atol=SUMS_ATOL, rtol=0)
    # the same exit step: the bodies one call replayed against the JAX
    # loop's iterations (its beam loop steps the model in every iteration,
    # after the bos step; its greedy loop once an iteration)
    entry, = pcap._graph_cache.values()
    bodies = sum(entry.replays[1:])
    assert entry.replays[0] == 1
    assert bodies == len(calls) - (kind == 'beam')
    assert bodies < pcap.cfg.seq_length        # the early exit fired


def test_second_call_returns_fresh_tensors():
    cap = _captioner('transformer')
    cap.graph_recorder = EagerRecorder
    fc, att, am = _torch(*inputs(B=3, seed=6))
    first = cap.sample_beam_graphed(fc, att, am, None, BEAM)
    kept = [first[0].clone(), first[1]['lp_sum'].clone(),
            first[2]['seq'].clone()]
    second = cap.sample_beam_graphed(fc * 0.5, att * -1.0, am, None, BEAM)
    assert len(cap._graph_cache) == 1
    # the first results did not move with the second call's replays
    assert torch.equal(first[0], kept[0])
    assert torch.equal(first[1]['lp_sum'], kept[1])
    assert torch.equal(first[2]['seq'], kept[2])
    assert not torch.equal(second[1]['lp_sum'], kept[1])
    entry, = cap._graph_cache.values()
    buffers = {v.data_ptr() for v in _tensors(entry.carry).values()}
    assert not buffers & {first[0].data_ptr(), second[0].data_ptr(),
                          second[1]['lp_sum'].data_ptr()}
    # and equal the eager decode of the same inputs
    eager = cap.sample_beam(fc * 0.5, att * -1.0, am, None, BEAM)
    assert torch.equal(second[0], eager[0])
    assert torch.equal(second[2]['seq'], eager[2]['seq'])


@pytest.mark.parametrize('change', [
    {'temperature': 0.7}, {'length_penalty': 'wu_0.9'},
    {'length_penalty': 'avg_0.3'}, {'suppress_UNK': 0}])
def test_a_baked_option_makes_a_new_entry(change):
    cap = _captioner('updown')
    cap.graph_recorder = EagerRecorder
    fc, att, am = _torch(*inputs(B=3, seed=7))
    base = cap.sample_beam_graphed(fc, att, am, None, BEAM)
    opt = dict(BEAM, **change)
    out = cap.sample_beam_graphed(fc, att, am, None, opt)
    assert len(cap._graph_cache) == 2
    eager = cap.sample_beam(fc, att, am, None, opt)
    assert torch.equal(out[0], eager[0])
    np.testing.assert_allclose(out[1]['lp_sum'], eager[1]['lp_sum'],
                               atol=SUMS_ATOL, rtol=0)
    assert base[0].shape == out[0].shape


def test_a_later_batch_size_captures_its_own():
    cap = _captioner('newfc')
    cap.graph_recorder = EagerRecorder
    for B in (4, 2, 4):
        fc, att, am = _torch(*inputs(B=B, seed=B))
        seq, stats = cap.sample_stats_graphed(fc, att, am, None, GREEDY)
        assert seq.shape == (B, cap.cfg.seq_length)
        eager = cap.sample_stats(fc, att, am, None, GREEDY)
        assert torch.equal(seq, eager[0])
    assert sorted(k[-3][0][0] for k in cap._graph_cache) == [2, 4]


@pytest.mark.parametrize('kind,opt,why', [
    ('beam', {'beam_size': 4, 'group_size': 2}, 'general beam body'),
    ('beam', {'beam_size': 3, 'decoding_constraint': 1},
     'general beam body'),
    ('stats', {'sample_method': 'top3'}, 'draws noise'),
    ('stats', {'sample_method': 'greedy', 'block_trigrams': 1},
     'step constraints'),
    ('stats', {'beam_size': 3}, 'beam search'),
])
def test_options_off_the_graph_routes_raise(kind, opt, why):
    cap = _captioner('transformer')
    fc, att, am = _torch(*inputs(B=2, seed=8))
    assert why in cap.graph_route(kind, opt)
    entry = (cap.sample_beam_graphed if kind == 'beam'
             else cap.sample_stats_graphed)
    with pytest.raises(ValueError, match='call sample_'):
        entry(fc, att, am, None, opt)
    # eval_split takes the eager entry for them, the graphed one otherwise
    assert eval_utils.decode_entry(cap, kind, opt).__name__ in (
        'sample_beam', 'sample_stats')
    assert eval_utils.decode_entry(cap, kind, BEAM if kind == 'beam'
                                   else GREEDY).__name__.endswith('_graphed')


def test_cpu_captioner_runs_the_program_eagerly():
    """Without a recorder a CPU captioner has no graphs: the same program
    runs eagerly and nothing is cached."""
    cap = _captioner('transformer')
    fc, att, am = _torch(*inputs(B=3, seed=9))
    seq, stats, done = cap.sample_beam_graphed(fc, att, am, None, BEAM)
    eager = cap.sample_beam(fc, att, am, None, BEAM)
    assert torch.equal(seq, eager[0]) and not cap._graph_cache


def test_graph_launches_count_captures_times_replays(monkeypatch):
    """Each graph holds the calls its capture recorded; ``launches`` is
    their count times the graph's replays."""
    def fake_kernel():
        pass
    fake_kernel.__name__ = 'fake_kernel_for_test'
    _build.counted(fake_kernel)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: capturing[0])

    class Recorder(EagerRecorder):
        def capture(self, fn):
            capturing[0] = True
            try:
                return super().capture(fn)
            finally:
                capturing[0] = False

    def setup_fn(fc, att, am):
        _build.count_launch(fake_kernel)
        return decoding.Carry(True, x=fc.clone(),
                              go=torch.ones((), dtype=torch.bool))

    def body(c, t):
        for _ in range(t + 1):          # step t launches t + 1 times
            _build.count_launch(fake_kernel)
        c.put(x=c['x'] + 1, go=torch.tensor(t < 1))

    try:
        prog = decoding.StepProgram(setup_fn, body, lambda c: c['x'], 4)
        entry = GraphDecode(prog, torch.zeros(2), None, None, Recorder())
        assert entry.held() == {'fake_kernel_for_test': 1 + 1 + 2 + 3 + 4}
        for _ in range(3):
            assert torch.equal(entry(torch.zeros(2), None, None),
                               torch.full((2,), 2.0))
        # each call replays the setup and steps 0, 1 (the exit after 1)
        assert entry.replays == [3, 3, 3, 0, 0]
        assert entry.launches() == {'fake_kernel_for_test': 3 * (1 + 1 + 2)}
    finally:
        _build.COUNTED.pop('fake_kernel_for_test')


def test_write_back_refuses_a_new_buffer():
    c = decoding.Carry(True, x=torch.zeros(3), state={'h': torch.zeros(2)})
    ptr = c['x'].data_ptr()
    c.put(x=torch.ones(3), state={'h': torch.ones(2), 't': 4})
    assert c['x'].data_ptr() == ptr and c['state']['t'] == 4
    assert torch.equal(c['state']['h'], torch.ones(2))
    with pytest.raises(ValueError, match='carry'):
        c.put(x=torch.ones(4))
    with pytest.raises(ValueError, match='carry'):
        c.put(state={'new': torch.ones(1)})
