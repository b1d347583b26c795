"""bf16 training with float32 master weights on the CPU (as
``test_torch_train_bf16.py``, whose bounds these tests share,
``tests/torch_bf16_util.py``): the XE step of UpDown and StackAtt (B3's and
B5's recompute paths) and the SCST grad step over fixed sequences and
rewards (UpDown, the transformer) against the JAX ``Trainer`` at
``compute_dtype='bfloat16'``; one fused SCST step of UpDown with the JAX
noise (the sequences the JAX step samples); each graphed bf16 step,
through ``engine.graphs.EagerRecorder``, bit-identical to its eager step
(losses, float32 parameters, Adam moments and bf16 copies), its body
reading nothing on the host."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine.graphs import EagerRecorder
from captioning_tpu_torch.ops.cider_device import DeviceCiderD
from tests.torch_bf16_util import (BF16, all_float32, bf16_trainer,
                                   check_bf16, jax_grads, port_grads, xe_run)
from tests.torch_graph_util import NoHostRead
from tests.torch_rl_util import B, N_SAMPLE, Both, write_df
from tests.torch_train_util import model_opt

@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def df(tmp_path_factory):
    return write_df(tmp_path_factory.mktemp('train_bf16'))


@pytest.mark.parametrize('model', ['updown', 'stackatt'])
def test_bf16_xe_step_matches_jax(model):
    j16, (pl, pg, pt) = xe_run(model_opt(model, **BF16))
    j32, _ = xe_run(model_opt(model, grad_clip_value=0))
    assert pt.captioner.cfg.dtype == torch.bfloat16
    assert pl[0] == pytest.approx(j16[0][0], rel=1e-2)
    np.testing.assert_allclose(pl, j16[0], rtol=1e-2)
    assert pl[-1] < pl[0]
    check_bf16(pg, j16[1], j32[1], 'gradient')
    all_float32(pt)
    got = pt.opt_state_jax()
    assert int(got['#1/#0/#0']) == int(j16[2]['#1/#0/#0']) == 3
    moments = [k for k in j16[2] if k != '#1/#0/#0']
    check_bf16({k: got[k] for k in moments}, {k: j16[2][k] for k in moments},
               {k: j32[2][k] for k in moments}, 'optimizer state',
               far=False)


def _fixed_rl(both, seed=0):
    """Sampled sequences [B n, L] (a random length each, then pads) and a
    reward [B n, L] from a seeded numpy stream."""
    rng = np.random.RandomState(seed)
    L, V = both.L, both.pcap.cfg.vocab_size
    n = B * N_SAMPLE
    seq = rng.randint(1, V + 1, (n, L))
    seq[np.arange(L)[None] >= rng.randint(2, L + 1, (n, 1))] = 0
    reward = np.repeat(rng.randn(n, 1), L, 1).astype(np.float32)
    return seq, reward


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_bf16_sc_grad_step_matches_jax(df, model):
    """The policy gradient over fixed sequences and rewards: no sampling
    has to agree."""
    runs = []
    for kw in (BF16, dict(grad_clip_value=0)):
        both = Both(model, df[0], **kw)
        seq, reward = _fixed_rl(both)
        jin = both.jargs('fc', 'att', 'am')
        pin = both.pargs('fc', 'att', 'am')
        _, state, out = both.jt.sc_grad_step(
            both.variables, both.state, *jin, jnp.asarray(seq, jnp.int32),
            jnp.asarray(reward), 1e-2, jax.random.PRNGKey(0))
        pout = both.pt.sc_grad_step(*pin, torch.from_numpy(seq),
                                    torch.from_numpy(reward), 1e-2,
                                    torch.Generator().manual_seed(0))
        runs.append((float(out['loss']), jax_grads(state),
                     float(pout['loss']), port_grads(both.pt), both.pt))
    (jl, jg16, pl, pg, pt), (_, jg32, _, _, _) = runs
    assert pt.captioner.cfg.dtype == torch.bfloat16
    assert pl == pytest.approx(jl, rel=1e-2)
    check_bf16(pg, jg16, jg32, 'gradient')
    all_float32(pt)


def test_bf16_sc_fused_step_matches_jax(df):
    """One fused SCST step of UpDown (the greedy baseline, the sampling
    pass with the JAX noise, the on-device reward, the policy gradient):
    the sequences the JAX step samples, the reward within 1e-2."""
    runs = []
    for kw in (BF16, dict(grad_clip_value=0)):
        both = Both('updown', df[0], **kw)
        jin = both.jargs('fc', 'att', 'am')
        pin = both.pargs('fc', 'att', 'am')
        refs_j, refs_p = both.jargs('refs', 'ref_mask'), both.pargs(
            'refs', 'ref_mask')
        jrng, pdraw = both.draws(0)
        jgreedy, jsampled = both.jt.sc_decode(both.variables, *jin, jrng,
                                              jrng)
        _, state, out = both.jt.sc_fused_step(
            both.variables, both.state, *jin, *refs_j, 1e-2, jrng, jrng,
            both.jsc)
        pout = both.pt.sc_fused_step(*pin, *refs_p, 1e-2, None, pdraw,
                                     torch.Generator().manual_seed(0),
                                     both.psc)
        np.testing.assert_array_equal(pout['greedy'].numpy(),
                                      np.asarray(jgreedy))
        np.testing.assert_array_equal(pout['sampled'].numpy(),
                                      np.asarray(jsampled))
        runs.append((out, jax_grads(state), pout, port_grads(both.pt),
                     both.pt))
    (jout, jg16, pout, pg, pt), (_, jg32, _, _, _) = runs
    assert float(pout['loss']) == pytest.approx(float(jout['loss']),
                                                rel=1e-2)
    assert float(pout['reward']) == pytest.approx(float(jout['reward']),
                                                  abs=1e-2)
    check_bf16(pg, jg16, jg32, 'gradient')
    all_float32(pt)


@pytest.mark.parametrize('kind,model', [
    ('xe', 'updown'), ('xe', 'stackatt'), ('xe', 'transformer'),
    ('xe', 'aoa'), ('sc_fused', 'updown'), ('sc_fused', 'transformer'),
    ('sc_grad', 'updown'), ('struc_fused', 'transformer'),
    ('struc_grad', 'updown')])
def test_graphed_bf16_step_equals_the_eager_one(kind, model, df):
    """3 steps of each route from one init and generator states: the
    losses, the float32 parameters and Adam moments and the bf16 copies
    bit for bit; the step body reads nothing on the host."""
    from tests.test_torch_graph_train import _batch, _calls
    trainers = [bf16_trainer(model), bf16_trainer(model)]
    trainers[1].graph_recorder = EagerRecorder
    scorer = DeviceCiderD(df[1], df[2], device='cpu')
    x = _batch(trainers[0].captioner)
    losses = []
    for tr, graphed in zip(trainers, (False, True)):
        prepare, step = _calls(tr, x, scorer)[kind]
        if graphed:
            step = getattr(tr, '%s_step_graphed' % kind)
        losses.append([float(step(*prepare())['loss']) for _ in range(3)])
    assert losses[0] == losses[1]
    for n, p in trainers[0].named_params.items():
        q = trainers[1].named_params[n]
        assert torch.equal(p, q) and p.dtype == torch.float32, n
        for key, v in trainers[0].optimizer.state[p].items():
            assert torch.equal(v, trainers[1].optimizer.state[q][key]), n
    for (_, a), (_, b) in zip(trainers[0].captioner._compute_pairs,
                              trainers[1].captioner._compute_pairs):
        assert torch.equal(a, b) and a.dtype == torch.bfloat16
    assert len(trainers[1]._graphs) == 1
    # a fourth step's body, outside the optimizer's host step count
    tr = trainers[0]
    prepare, step = _calls(tr, x, scorer)[kind]
    update = tr.optimizer.step

    def outside(*a, **k):
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            return update(*a, **k)

    tr.optimizer.step = outside
    args = prepare()
    with NoHostRead():
        out = step(*args)
    assert torch.isfinite(out['loss'])


