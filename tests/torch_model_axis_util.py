"""Rank side of the port's model-axis tests (``--mesh_shape
data:D,model:M``): each rank builds the mesh, loads the JAX variables of
a case into the port, shards its vocab tensors (``Captioner.shard_vocab``)
and runs the case on its data index's rows; results come back as the
JAX package's flat trees, the shards gathered.

    python -m tests.torch_model_axis_util <function> <payload> <rank>
        <world> <store>

(``tests.torch_parallel_util.start_ranks(..., module=MODULE)``)."""

from __future__ import annotations

import os
import sys

MODULE = 'tests.torch_model_axis_util'


def _port(case, grid):
    from tests.torch_parallel_util import _port as load
    return load(case['opt'], case['variables']).shard_vocab(grid)


def _full_grads(pt):
    """The gradients as the clip sees them, gathered into the JAX
    package's flat 'params/...' tree."""
    from captioning_tpu_torch.utils.weights import jax_from_state_dict
    grads = pt.captioner.full_state({k: p.grad.clone() for k, p in
                                     pt.named_params.items()})
    return jax_from_state_dict(grads, pt.captioner.cfg, params_only=True)


def _record(pt):
    seen = []
    clip = pt.clip

    def record(params):
        if not seen:
            seen.append(_full_grads(pt))
        return clip(params)
    pt.clip = record
    return seen


def _rows(case, grid, n=1):
    """This data index's rows of the global batch (``n`` rows an image)."""
    from captioning_tpu_torch.parallel import mesh
    sl = mesh.local_batch_slice(case['fc'].shape[0])
    return sl, slice(sl.start * n, sl.stop * n)


def xe(case, grid):
    """``case['steps']`` XE steps; the first step's gradients, the losses,
    the parameters and the optimizer state after (full arrays), the
    shards' shapes, the step's route."""
    import torch

    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.utils.misc import _flatten_tree
    pcap = _port(case, grid)
    pt = Trainer(pcap, case['opt'])
    sl, _ = _rows(case, grid)
    args = [torch.from_numpy(case[k][sl])
            for k in ('fc', 'att', 'labels', 'masks', 'am')]
    seen = _record(pt)
    losses = [float(pt.xe_step(*args, case['lr'], 0.0,
                               torch.Generator().manual_seed(s))['loss'])
              for s in range(case['steps'])]
    out = {'loss': losses, 'grads': seen[0],
           'params': _flatten_tree(pcap.jax_variables()),
           'opt_state': pt.opt_state_jax(), 'route': pt.graph_route('xe'),
           'shards': {n: tuple(p.shape) for n, p in pt.named_params.items()
                      if n in pcap.vocab_shards}}
    if case.get('ckpt'):
        out['resumed'] = _save_and_resume(case, grid, pt)
    return out


def _save_and_resume(case, grid, pt):
    """Rank 0 writes the checkpoint (model.npz, optimizer.npz, the infos)
    from the gathered arrays, as tools/train_torch.py does; then every
    rank loads it as ``--start_from`` does (full arrays, cut to its
    shards): the largest difference from the live shards and moments."""
    from types import SimpleNamespace

    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.parallel import mesh
    from captioning_tpu_torch.utils import misc
    variables, state = pt.captioner.jax_variables(), pt.opt_state_jax()
    opt = SimpleNamespace(checkpoint_path=case['ckpt'], id='ma')
    if mesh.is_main_process():
        misc.save_checkpoint(opt, variables, {'iter': 1}, state)
    mesh.barrier()
    cap = _port(dict(case, variables=misc.load_pytree(
        os.path.join(case['ckpt'], 'model.npz'))), grid)
    tr = Trainer(cap, case['opt'])
    tr.load_opt_state_jax(misc.load_flat(os.path.join(case['ckpt'],
                                                      'optimizer.npz')))
    worst = 0.0
    for name, p in pt.named_params.items():
        q = tr.named_params[name]
        worst = max(worst, float((p - q).abs().max()))
        for key, v in pt.optimizer.state[p].items():
            if v.dim():
                worst = max(worst, float(
                    (v - tr.optimizer.state[q][key]).abs().max()))
    return worst


def decode(case, grid):
    """Beam (``case['beam']``) and greedy over this data index's rows: the
    tokens, and the decode's route."""
    import torch
    pcap = _port(case, grid)
    sl, _ = _rows(case, grid)
    fc, att, am = (torch.from_numpy(case[k][sl]) for k in ('fc', 'att',
                                                             'am'))
    beam = {'beam_size': case['beam'], 'sample_n': 1, 'group_size': 1}
    greedy = {'sample_method': 'greedy', 'beam_size': 1}
    seq_beam, _, _ = pcap.sample_beam(fc, att, am, None, beam)
    seq_greedy, _ = pcap.sample_stats(fc, att, am, None, greedy)
    return {'beam': seq_beam.numpy(), 'greedy': seq_greedy.numpy(),
            'route': pcap.graph_route('beam', beam)}


def rl(case, grid):
    """One fused SCST (``kind`` 'sc': the greedy baseline through B2's
    shard mode, the reward on the device) or structure-loss step ('struc';
    PPO's frozen old policy, unsharded, with ``old_variables``) on this
    data index's images, its sampling noise those rows of the global
    table: the reported values, the tokens and the first gradients."""
    import numpy as np
    import torch

    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.ops.cider_device import DeviceCiderD
    from tests.torch_parallel_util import _port as load
    old = case.get('old_variables')
    pt = Trainer(_port(case, grid), case['opt'], old_captioner=None
                 if old is None else load(case['opt'], old))
    n = int(case['opt'].train_sample_n)
    sl, rows = _rows(case, grid, n)

    def draw(kind, t, shape):
        assert kind == 'gumbel'
        return torch.from_numpy(case['noise'][t][rows])

    def take(*names):
        return [torch.from_numpy(np.asarray(case[k][sl])) for k in names]
    seen = _record(pt)
    scorer = DeviceCiderD(case['df_path'], device='cpu')
    gen = torch.Generator().manual_seed(0)
    if case['kind'] == 'sc':
        out = pt.sc_fused_step(*take('fc', 'att', 'am', 'refs', 'ref_mask'),
                               case['lr'], None, draw, gen, scorer)
    else:
        out = pt.struc_fused_step(
            *take('fc', 'att', 'labels', 'masks', 'am', 'refs', 'ref_mask'),
            case['lr'], draw, gen, torch.Generator().manual_seed(1), scorer)
    return {'values': {k: v.numpy() for k, v in out.items()},
            'grads': seen[0], 'route': pt.graph_route(case['kind'] +
                                                      '_fused')}


def layout(case, grid):
    """The mesh as this rank sees it: its indices and its groups' ranks."""
    import torch.distributed as dist
    return {'data': grid.data, 'model': grid.model,
            'data_index': grid.data_index, 'model_index': grid.model_index,
            'model_group': dist.get_process_group_ranks(grid.model_group),
            'data_group': dist.get_process_group_ranks(grid.data_group)}



# -- the test process's side (JAX imported inside the functions) -----------

B, LR = 5, 1e-2
TF = dict(N_enc=1, N_dec=1)
NORM_CLIP = dict(grad_clip_mode='norm', grad_clip_value=0.5)


def init(opt, seed=0):
    """The port's captioner of ``opt`` from its seeded init."""
    import torch

    from captioning_tpu_torch.models.api import setup
    from tests.torch_port_util import tiny_vocab
    cap = setup(opt, tiny_vocab(), device='cpu')
    cap.init_params(torch.Generator().manual_seed(seed))
    return cap


def xe_case(model, steps=2, **kw):
    """An XE case: ``model``'s options, its init as JAX variables, the
    global batch (ragged captions)."""
    from tests.torch_port_util import inputs, train_batch
    from tests.torch_train_util import model_opt
    opt = model_opt(model, **kw)
    fc, att, am = inputs(B)
    labels, masks = train_batch(B, 5)
    return dict(kind='xe', opt=opt, variables=init(opt).jax_variables(),
                fc=fc, att=att, am=am, labels=labels, masks=masks, lr=LR,
                steps=steps)


def rl_case(kind, model, df_path, **kw):
    """An RL case: the options, the init, the batch, its references and
    the JAX engine's sampling noise (PPO: an old policy's variables)."""
    from tests.torch_port_util import inputs, jax_draws, train_batch
    from tests.torch_rl_util import references, rl_opt
    opt = rl_opt(model, **kw)
    pcap = init(opt)
    fc, att, am = inputs(B)
    case = dict(kind=kind, opt=opt, variables=pcap.jax_variables(), fc=fc,
                att=att, am=am, lr=LR, df_path=df_path)
    case['labels'], case['masks'] = train_batch(B, int(opt.train_sample_n))
    case['gts'], case['refs'], case['ref_mask'] = references(pcap, fc, att,
                                                             am)
    draw = jax_draws(7, pcap.cfg.seq_length)
    rows = B * int(opt.train_sample_n)
    case['noise'] = [draw('gumbel', t, (rows, pcap.cfg.vocab_size + 1))
                     .numpy() for t in range(pcap.cfg.seq_length)]
    if kw.get('use_ppo'):
        case['old_variables'] = init(opt, seed=1).jax_variables()
    return case


def jax_xe(case, mesh_shape):
    """The JAX ``xe_step``s on its mesh, the variables and the optimizer
    state placed by ``shard_variables``: losses, the first step's
    gradients, the optimizer state after."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.modules.trainer import Trainer as JaxTrainer
    from captioning_tpu.parallel.mesh import (make_mesh, shard_batch,
                                              shard_variables)
    from captioning_tpu.utils.misc import _flatten_tree
    from tests.torch_port_util import tiny_vocab
    opt = case['opt']
    jt = JaxTrainer(jax_setup(opt, tiny_vocab()), opt)
    apply = jt._apply_updates

    def keep_grads(variables, state, grads, lr):
        variables, state = apply(variables, state[0], grads, lr)
        return variables, (state, grads)
    jt._apply_updates = keep_grads
    grid = make_mesh(mesh_shape)
    out = {'loss': []}
    with grid:
        variables = shard_variables(jax.tree.map(jnp.asarray,
                                                 case['variables']), grid)
        state = (shard_variables(jt.init_opt_state(variables), grid),
                 jax.tree.map(jnp.zeros_like, variables['params']))
        b = shard_batch({'fc': case['fc'], 'att': case['att'],
                         'am': case['am'], 'masks': case['masks'],
                         'labels': case['labels'].astype('int32')}, grid)
        for s in range(case['steps']):
            variables, state, o = jt.xe_step(
                variables, state, b['fc'], b['att'], b['labels'],
                b['masks'], b['am'], LR, 0.0, jax.random.PRNGKey(s))
            out['loss'].append(float(o['loss']))
            if s == 0:
                out['grads'] = _flatten_tree({'params': jax.tree.map(
                    np.asarray, state[1])})
        out['opt_state'] = _flatten_tree(jax.tree.map(np.asarray, state[0]))
    return out


def jax_decode(case, mesh_shape):
    """Beam and greedy tokens of the JAX decodes on its mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from captioning_tpu.models import setup as jax_setup
    from captioning_tpu.parallel.mesh import (make_mesh, shard_batch,
                                              shard_variables)
    from tests.torch_port_util import tiny_vocab
    jcap = jax_setup(case['opt'], tiny_vocab())
    grid = make_mesh(mesh_shape)
    with grid:
        variables = shard_variables(jax.tree.map(jnp.asarray,
                                                 case['variables']), grid)
        b = shard_batch({k: case[k] for k in ('fc', 'att', 'am')}, grid)
        beam, _, _ = jcap.sample_beam_jit(
            variables, b['fc'], b['att'], b['am'], jax.random.PRNGKey(0),
            {'beam_size': case['beam'], 'sample_n': 1, 'group_size': 1},
            want_logps=False)
        greedy, _ = jcap.sample_stats_jit(
            variables, b['fc'], b['att'], b['am'], jax.random.PRNGKey(0),
            {'sample_method': 'greedy', 'beam_size': 1})
    return {'beam': np.asarray(beam), 'greedy': np.asarray(greedy)}


def check_grads(want, got, rel=1e-5, floor=1e-7):
    """Each gradient within ``rel`` of its tensor's largest magnitude, plus
    ``floor`` of the model's largest (a gradient that is 0 up to
    rounding)."""
    import numpy as np
    assert sorted(got) == sorted(want) and want
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        np.testing.assert_allclose(
            got[key], w, rtol=0, err_msg=key,
            atol=rel * float(np.abs(w).max()) + floor * top)


def check_state(want, got, atol=1e-6):
    """Each array of an optimizer state within ``atol``."""
    import numpy as np
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=atol, rtol=0,
                                   err_msg=key)


FNS = {'xe': xe, 'decode': decode, 'sc': rl, 'struc': rl,
       'layout': layout}


def model_axis_cases(payload, rank, world):
    """Every case of ``payload['cases']`` ({name: case}) in turn on the
    mesh ``payload['mesh_shape']``."""
    import torch

    from captioning_tpu_torch.parallel import mesh
    torch.manual_seed(0)
    grid = mesh.make_mesh(payload['mesh_shape'])
    return {name: FNS[case['kind']](case, grid)
            for name, case in payload['cases'].items()}


if __name__ == '__main__':
    from tests.torch_parallel_util import main
    main(sys.argv[1:], globals())
