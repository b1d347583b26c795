"""bf16 training with float32 master weights (``--compute_dtype
bfloat16``) on the CPU at tiny widths, against the JAX ``Trainer`` at
``compute_dtype='bfloat16'`` from the same weights (``jax_and_port``: the
JAX init carried across by ``state_dict_from_jax``) on the same numpy
batch, dropout 0, ``ss_prob`` 0 (``tests/torch_bf16_util.py``):

* the XE step of the transformer, AoANet and ShowTell (UpDown's and
  StackAtt's, with the RL steps, in ``test_torch_train_bf16_steps.py``):
  the first loss and a 3-step trajectory within 1e-2 relative of the JAX
  bf16 ones; each gradient within 2e-2 of the JAX bf16 gradient in
  relative L2 plus twice the distance between the JAX package's own bf16
  and float32 gradients of that tensor (the rounding noise of bf16: the
  two frameworks round their bf16 chains at different points, XLA's CPU
  expansions of sigmoid and softmax and its Dense's separate bias add
  against PyTorch's single-rounding ops, so their bf16 noise is
  independent; PERF.md, section 6), and at least a quarter of the JAX
  package's bf16-to-float32 distance away from the float32 gradient (a
  step that quietly ran in float32 sits within float32 rounding of it);
  after 3 steps every parameter, gradient and Adam moment float32 and the
  optimizer state in the JAX layout within the same bound a tensor;
* the port's compute-dtype copies give bit for bit the gradients of a
  cast at every use, the JAX package's cast sites, and not those of one
  cast a step (whose uses sum in bf16);
* after 2 bf16 updates the eager and the graphed decode of the trained
  captioner give the tokens of a fresh captioner loaded from its float32
  masters, its copies rewritten in place (the addresses a CUDA graph
  holds); the bf16 decodes give the tokens and sums of the same weights
  cast in place, as before float32 masters."""

import numpy as np
import pytest
import torch

from captioning_tpu_torch.engine.graphs import EagerRecorder
from captioning_tpu_torch.models import layers as players
from captioning_tpu_torch.models.api import setup
from captioning_tpu_torch.modules.trainer import Trainer
from tests.torch_bf16_util import (BF16, all_float32, bf16_trainer,
                                   check_bf16, xe_run)
from tests.torch_port_util import (inputs, jax_and_port, tiny_vocab,
                                   train_batch)
from tests.torch_train_util import model_opt

@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_fixed_dropout(monkeypatch):
    """AoANet's sites at the literal rate 0.1 at 0 on both sides."""
    from captioning_tpu.models import aoa as jaoa
    from captioning_tpu.models.layers import Dropout
    from captioning_tpu_torch.models import aoa as paoa
    monkeypatch.setattr(jaoa, 'Dropout', lambda rate: Dropout(0.0))
    monkeypatch.setattr(paoa, 'DROPOUT', 0.0)


@pytest.mark.parametrize('model', ['transformer', 'aoa', 'show_tell'])
@pytest.mark.usefixtures('no_fixed_dropout')
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


def _one_step_grads(model):
    """The port's first bf16 XE step's gradients."""
    opt = model_opt(model, **BF16)
    _, _, pcap = jax_and_port(opt=opt)
    fc, att, am = inputs(4)
    labels, masks = train_batch(4, 5)
    pt = Trainer(pcap, opt)
    pt.xe_step(*[torch.from_numpy(a) for a in (fc, att, labels, masks, am)],
               1e-2, 0.0, torch.Generator().manual_seed(0))
    return {n: p.grad.clone() for n, p in pt.named_params.items()}


@pytest.mark.parametrize('model,scan', [('updown', True),
                                        ('transformer', False)])
def test_copies_equal_a_cast_at_every_use(model, scan, monkeypatch):
    """The copies with ``CastUse`` are the JAX cast sites exactly: a
    ``.to(bf16)`` at every use (whose transpose casts each use's gradient
    to float32) gives the same gradients bit for bit; one cast a step,
    whose uses sum in bf16, does not where a weight has several uses (the
    RNN's time steps; the transformer's teacher-forced pass uses each
    weight once)."""
    from captioning_tpu_torch.models import harness, transformer
    mods = (players, harness, transformer)

    def per_use(module, name):
        p = getattr(module, name)
        copy = module._buffers.get(name + '_c')
        return p if copy is None else p.to(copy.dtype)

    cache = {}

    def per_step(module, name):
        key = (id(module), name)
        if key not in cache:
            cache[key] = per_use(module, name)
        return cache[key]

    ours = _one_step_grads(model)
    got = {}
    for name, cast in (('per_use', per_use), ('per_step', per_step)):
        for m in mods:
            if hasattr(m, 'compute_param'):
                monkeypatch.setattr(m, 'compute_param', cast)
        got[name] = _one_step_grads(model)
        monkeypatch.undo()
    for n, g in ours.items():
        assert torch.equal(g, got['per_use'][n]), n
    assert scan == any(not torch.equal(g, got['per_step'][n])
                       for n, g in ours.items())


GREEDY = {'sample_method': 'greedy', 'beam_size': 1}
BEAM = {'beam_size': 3, 'sample_n': 1, 'group_size': 1}


def _decodes(cap, fc, att, am):
    """(eager greedy, graphed greedy, eager beam, graphed beam) tokens."""
    return (cap.sample_stats(fc, att, am, None, GREEDY)[0],
            cap.sample_stats_graphed(fc, att, am, None, GREEDY)[0],
            cap.sample_beam(fc, att, am, None, BEAM)[0],
            cap.sample_beam_graphed(fc, att, am, None, BEAM)[0])


@pytest.mark.parametrize('model', ['updown', 'transformer'])
def test_decodes_after_bf16_updates_read_the_new_weights(model):
    """Graph decodes cached before 2 bf16 updates (``EagerRecorder``),
    then decoding again: the eager and graphed tokens of a fresh
    captioner loaded from the trained one's float32 masters; the copies
    keep their addresses and equal the masters cast to bf16."""
    tr = bf16_trainer(model, drop_prob_lm=0.0, dropout=0.0)
    cap = tr.captioner
    cap.graph_recorder = EagerRecorder
    t = torch.from_numpy
    fc, att, am = (t(a) for a in inputs(4))
    labels, masks = (t(a) for a in train_batch(4, 5))
    before = _decodes(cap, fc, att, am)
    ptrs = [c.data_ptr() for _, c in cap._compute_pairs]
    for step in range(2):
        tr.xe_step(fc, att, labels, masks, am, 5e-2, 0.0,
                   torch.Generator().manual_seed(step))
    assert [c.data_ptr() for _, c in cap._compute_pairs] == ptrs
    for p, c in cap._compute_pairs:
        assert torch.equal(c, p.detach().to(torch.bfloat16))
    fresh = setup(tr.opt, tiny_vocab(), 'cpu').load_jax_variables(
        cap.jax_variables())
    want = fresh.sample_stats(fc, att, am, None, GREEDY)[0], \
        fresh.sample_beam(fc, att, am, None, BEAM)[0]
    got = _decodes(cap, fc, att, am)
    for g, w in zip(got, (want[0], want[0], want[1], want[1])):
        assert torch.equal(g, w)
    # the updates moved the decode, and the cached graphs were reused
    assert any(not torch.equal(a, b) for a, b in zip(before, got))
    assert len(cap._graph_cache) == 2


def _cast_in_place(cap):
    """``cap`` as a bf16 captioner computed before float32 masters: its
    Linear and Embedding parameters cast in place, no copies."""
    from torch import nn
    module = cap.module
    for m in module.modules():
        for name in [n for n in m._buffers if n.endswith('_c')]:
            del m._buffers[name]
        if isinstance(m, (nn.Linear, players.Embedding)):
            m.to(torch.bfloat16)
    if hasattr(module, 'tgt_embed'):
        module.tgt_embed.data = module.tgt_embed.data.to(torch.bfloat16)
    cap._compute_pairs = []
    return cap


@pytest.mark.parametrize('model', ['updown', 'stackatt', 'transformer',
                                   'aoa', 'show_tell'])
def test_bf16_decodes_equal_the_in_place_cast(model):
    """The bf16 eval decodes through the copies give the tokens and sums,
    bit for bit, of the same weights cast in place (the design before
    float32 masters)."""
    opt = model_opt(model, compute_dtype='bfloat16')
    _, variables, cap = jax_and_port(opt=opt)
    old = _cast_in_place(setup(opt, tiny_vocab(), 'cpu').load_jax_variables(
        variables))
    t = [torch.from_numpy(a) for a in inputs(4, seed=1)]
    for a, b in zip(_decodes(cap, *t), _decodes(old, *t)):
        assert torch.equal(a, b)
    for opts in (GREEDY, dict(BEAM, beam_size=2)):
        entry = (cap.sample_stats if opts is GREEDY else cap.sample_beam)
        entry_old = (old.sample_stats if opts is GREEDY else old.sample_beam)
        for x, y in zip(entry(*t, None, opts)[1].values(),
                        entry_old(*t, None, opts)[1].values()):
            assert torch.equal(x, y)
