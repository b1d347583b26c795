"""The port's ensemble (``models/ensemble.py``) against the JAX package's
``EnsembleCaptioner``, float32 on the CPU: a tiny UpDown (2 layers) and a
tiny transformer, initialised by the JAX package and loaded into the port,
weights 1:3.  The mixture step's logprobs within 1e-5; greedy, beam 4 and
diverse beam (2 groups, lambda 0.5) tokens identical, the finished beams'
``seq`` identical and ``p`` within 1e-5; the teacher-forced mixture within
1e-5.  Then the port alone: identical members decode as the single model,
the transformer member's ancestry equals an all-physical reorder, the
graph entries (through ``graphs.EagerRecorder``) equal the eager ones and
their step bodies read nothing on the host.  Last,
``tools/eval_ensemble_torch.py --device cpu`` against
``tools/eval_ensemble.py`` on two checkpoints of the synthetic dataset:
the same ``vis/vis.json`` captions."""

import dataclasses
import json
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine import decoding
from captioning_tpu_torch.engine.graphs import EagerRecorder
from captioning_tpu_torch.models.ensemble import EnsembleCaptioner
from tests.torch_graph_util import NoHostRead
from tests.torch_port_util import (inputs, jax_and_port, jax_tool_main,
                                   port_cli_beside, tiny_opt, tiny_rnn_opt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = [1.0, 3.0]
GREEDY = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}
BEAM4 = {'beam_size': 4, 'sample_n': 1, 'group_size': 1, 'suppress_UNK': 1}
DBS = {'beam_size': 4, 'group_size': 2, 'diversity_lambda': 0.5,
       'sample_n': 1}
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def members():
    """[(JAX captioner, variables, port captioner)] of UpDown (2 layers)
    and the transformer, the latter's EOS raised so captions end early."""
    return [jax_and_port(0, opt=tiny_rnn_opt('updown', num_layers=2)),
            jax_and_port(1, eos_boost=2.0, opt=tiny_opt())]


@pytest.fixture(scope='module')
def ensembles(members):
    """(JAX ensemble, its variables list, port ensemble): one JAX ensemble
    whose compiled programs every parity case shares."""
    from captioning_tpu.models.ensemble import EnsembleCaptioner as JaxEns
    return (JaxEns([m[0] for m in members], WEIGHTS),
            [m[1] for m in members],
            EnsembleCaptioner([m[2] for m in members], WEIGHTS))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_mixture_step_matches_jax(ensembles):
    import jax
    import jax.numpy as jnp
    je, jvars, pe = ensembles
    fc, att, am = inputs(B=3, seed=4)
    pdm = pe.bind()

    @jax.jit
    def jax_steps(jvars, fc, att, am):
        # three steps, each fed the last one's argmax
        jdm = je.bind(jvars)
        feats = jdm.prepare(fc, att, am, jax.random.PRNGKey(0))
        state = jdm.init_state(3)
        it = jnp.zeros(3, jnp.int32)
        out = []
        for _ in range(3):
            lp, state = jdm.step(it, feats, state, None, True,
                                 uniform_t=True)
            out.append(lp)
            it = lp.argmax(-1)
        return jnp.stack(out)

    want = np.asarray(jax_steps(jvars, fc, att, am))
    with torch.inference_mode():
        feats = pdm.prepare(*_torch(fc, att, am), None)
        state = pdm.init_state(3)
        it = torch.zeros(3, dtype=torch.long)
        for t in range(3):
            lp, state = pdm.step(it, feats, state, None, True,
                                 uniform_t=True)
            np.testing.assert_allclose(lp.numpy(), want[t], atol=ATOL)
            it = torch.from_numpy(want[t].argmax(-1))
    assert pe.weights.tolist() == [0.25, 0.75]


@pytest.mark.parametrize('mode', ['greedy', 'beam4', 'dbs'])
def test_mixed_ensemble_decodes_as_jax(ensembles, mode):
    import jax
    je, jvars, pe = ensembles
    fc, att, am = inputs(B=4, seed=5)
    if mode == 'greedy':
        js, jlp = je.sample_jit(jvars, fc, att, am, jax.random.PRNGKey(0),
                                GREEDY)
        ps, stats = pe.sample_stats(*_torch(fc, att, am), None, GREEDY)
        js, jlp = np.asarray(js), np.asarray(jlp)
        np.testing.assert_array_equal(ps.numpy(), js)
        # the JAX tables' sums, as the JAX eval_split takes them
        np.testing.assert_allclose(stats['ent_sum'].numpy(),
                                   -(np.exp(jlp) * jlp).sum((1, 2)),
                                   atol=1e-4)
        np.testing.assert_allclose(
            stats['lp_sum'].numpy(),
            np.take_along_axis(jlp, js[..., None], 2).sum((1, 2)),
            atol=1e-4)
        return
    opt = BEAM4 if mode == 'beam4' else DBS
    js, jst, jd = je.sample_beam_jit(jvars, fc, att, am,
                                     jax.random.PRNGKey(0), opt,
                                     want_logps=False)
    ps, pst, pd = pe.sample_beam(*_torch(fc, att, am), None, opt)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pd['seq'].numpy(), np.asarray(jd['seq']))
    np.testing.assert_allclose(pd['p'].numpy(), np.asarray(jd['p']),
                               atol=ATOL)
    for k in ('ent_sum', 'lp_sum'):
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-4)


def test_forward_tf_matches_jax(ensembles):
    je, jvars, pe = ensembles
    fc, att, am = inputs(B=3, seed=6)
    seq = np.random.RandomState(6).randint(1, 29, (3, 2, 6))
    want = je.forward_tf_jit(jvars, fc, att, seq, am)
    got = pe.forward_tf(*_torch(fc, att), torch.from_numpy(seq),
                        torch.from_numpy(am))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match='eval-only'):
        pe.forward_tf(*_torch(fc, att), torch.from_numpy(seq),
                      torch.from_numpy(am), train=True)


@pytest.mark.parametrize('mode', ['greedy', 'beam4'])
def test_identical_members_decode_as_the_single_model(members, mode):
    cap = members[1][2]
    ens = EnsembleCaptioner([cap, cap], [1.0, 1.0])
    x = _torch(*inputs(B=4, seed=7))
    if mode == 'greedy':
        want, _ = cap.sample_stats(*x, None, GREEDY)
        got, _ = ens.sample_stats(*x, None, GREEDY)
    else:
        want, _, _ = cap.sample_beam(*x, None, BEAM4)
        got, _, _ = ens.sample_beam(*x, None, BEAM4)
    assert torch.equal(got, want)


@pytest.mark.parametrize('opt', [BEAM4, DBS], ids=['beam4', 'dbs'])
def test_ancestry_equals_physical_reorder(ensembles, opt):
    """The transformer member's beam attends through its ancestry table
    (its caches never move); the all-physical reorder gathers every state
    row, the UpDown member's and the caches alike."""
    pe = ensembles[2]
    x = _torch(*inputs(B=3, seed=8))
    dm = pe.bind()
    with torch.inference_mode():
        s1, _, d1 = decoding.sample_beam(dm, *x, None, opt)
        dm0 = dataclasses.replace(dm, beam_init=None, beam_reorder=None)
        s2, _, d2 = decoding.sample_beam(dm0, *x, None, opt)
    assert torch.equal(s1, s2) and torch.equal(d1['seq'], d2['seq'])
    np.testing.assert_allclose(d1['p'].numpy(), d2['p'].numpy(), atol=ATOL)


@pytest.mark.parametrize('kind', ['beam', 'stats'])
def test_graph_entries_equal_eager(ensembles, kind):
    """The graph entries on the CPU (the program run eagerly) and through
    the graph cache (``EagerRecorder``) give the eager entries' tokens and
    sums; after one warm-up decode no step body reads a tensor on the
    host; the cache keys hold every member's compute dtype."""
    pe = ensembles[2]
    x = _torch(*inputs(B=3, seed=9))
    opt = BEAM4 if kind == 'beam' else GREEDY
    eager = pe.sample_beam if kind == 'beam' else pe.sample_stats
    graphed = (pe.sample_beam_graphed if kind == 'beam'
               else pe.sample_stats_graphed)
    want = eager(*x, None, opt)
    ens = EnsembleCaptioner(pe.members, WEIGHTS)
    outs = [graphed(*x, None, opt)]
    ens.graph_recorder = EagerRecorder
    outs += [getattr(ens, graphed.__name__)(*x, None, opt) for _ in range(2)]
    for got in outs:
        assert torch.equal(got[0], want[0])
        for k in ('ent_sum', 'lp_sum'):
            torch.testing.assert_close(got[1][k], want[1][k], rtol=0,
                                       atol=ATOL)
    (key, entry), = ens._graph_cache.items()
    assert key[2] == (torch.float32, torch.float32)
    make = decoding.beam_program if kind == 'beam' else \
        decoding.sample_program
    prog = make(ens.bind(), opt)
    with torch.inference_mode():
        decoding.run_eager(prog, *x)
        carry = prog.setup(*_torch(*inputs(B=3, seed=10)))
        with NoHostRead():
            for t in range(prog.steps):
                prog.body(carry, t)
    with pytest.raises(ValueError, match='general beam body'):
        ens.sample_beam_graphed(*x, None, DBS)


def test_members_on_two_devices_raise():
    a = SimpleNamespace(device=torch.device('cpu'))
    b = SimpleNamespace(device=torch.device('cuda', 0))
    with pytest.raises(ValueError, match='more than one device'):
        EnsembleCaptioner([a, b])


def _checkpoint(root, ds, model, mid, seed, **kw):
    import jax

    from captioning_tpu.data.dataset import DataLoader
    from captioning_tpu.models import setup
    from captioning_tpu.utils import misc
    from tests.util_synth import make_opt

    opt = make_opt(ds, model, id=mid, use_pallas=1)
    for k, v in kw.items():
        setattr(opt, k, v)
    loader = DataLoader(opt)
    opt.vocab_size = loader.vocab_size
    cap = setup(opt, loader.get_vocab())
    variables = cap.init_params(jax.random.PRNGKey(seed), att_len=7)
    log = root / ('log_' + mid)
    log.mkdir()
    misc.save_pytree(variables, str(log / 'model.npz'))
    with open(log / ('infos_%s.pkl' % mid), 'wb') as f:
        misc.pickle_dump({'opt': opt, 'vocab': loader.get_vocab()}, f)


def test_eval_ensemble_cli_matches_jax(tmp_path, monkeypatch):
    from tests.util_synth import build_synthetic_dataset
    ds = build_synthetic_dataset(str(tmp_path / 'synth'))
    _checkpoint(tmp_path, ds, 'updown', 'eup', 0)
    _checkpoint(tmp_path, ds, 'transformer', 'etf', 1, N_enc=2, N_dec=2,
                d_model=16, d_ff=32, num_att_heads=4)
    args = ['--ids', 'eup', 'etf', '--weights', '1', '3', '--split', 'val',
            '--num_images', '4', '--language_eval', '0', '--beam_size', '3',
            '--max_length', '6', '--dump_images', '0']
    for name in ('jax', 'port'):
        (tmp_path / name).mkdir()
        for mid in ('eup', 'etf'):
            os.symlink(tmp_path / ('log_' + mid),
                       tmp_path / name / ('log_' + mid))
    monkeypatch.chdir(tmp_path / 'jax')
    port_cli_beside(
        [os.path.join(REPO, 'tools', 'eval_ensemble_torch.py'), '--device',
         'cpu'] + args, tmp_path / 'port',
        lambda: jax_tool_main(os.path.join(REPO, 'tools',
                                           'eval_ensemble.py'), args,
                              monkeypatch))
    out = {}
    for name in ('jax', 'port'):
        with open(tmp_path / name / 'vis' / 'vis.json') as f:
            out[name] = json.load(f)
    want, got = out['jax'], out['port']
    assert len(got) == 4
    assert [(p['image_id'], p['caption']) for p in got] == \
        [(p['image_id'], p['caption']) for p in want]
    for key in ('entropy', 'perplexity'):
        np.testing.assert_allclose([p[key] for p in got],
                                   [p[key] for p in want], atol=1e-4)
    with open(tmp_path / 'port' / 'eval_results'
              / '.saved_pred_eup1.0+etf3.0_val.pkl', 'rb') as f:
        assert pickle.load(f)[0] == got


def test_eval_ensemble_cli_cuda_without_gpu_raises(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'eval_ensemble_torch', os.path.join(REPO, 'tools',
                                            'eval_ensemble_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mod.main(['--ids', 'a', 'b'])


def test_chip_smoke_eval_split_routes(ensembles, tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 17's pieces on the CPU: its feature loader
    through ``eval_split``, and its ``EagerRoute``, which sends
    ``eval_split`` to the eager entries, give the graph entries'
    captions."""
    import importlib.util

    from captioning_tpu_torch.utils import eval_utils
    from tests.torch_port_util import tiny_vocab
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.chdir(tmp_path)         # eval_split writes eval_results/
    pe = ensembles[2]
    loader = cs.FeatureLoader(*inputs(B=4, seed=11), tiny_vocab())
    eager = cs.EagerRoute(pe)
    assert eval_utils.decode_entry(eager, 'beam', BEAM4) == pe.sample_beam
    assert eval_utils.decode_entry(pe, 'beam', BEAM4) == \
        pe.sample_beam_graphed
    for opt in (BEAM4, GREEDY):
        kw = dict(opt, split='test', num_images=4, verbose=False,
                  id='phase17')
        want = eval_utils.eval_split(pe, loader, kw)[1]
        got = eval_utils.eval_split(eager, loader, kw)[1]
        assert len(got) == 4
        assert [p['caption'] for p in got] == [p['caption'] for p in want]
