"""Shared set-up of the port's data-parallel tests: rank processes on the
CPU (gloo), each running one of the ``*_case`` functions below on its
slice of a global batch, held by the tests against the JAX package's
one-device step or eval on the whole batch.

    python -m tests.torch_parallel_util <function> <payload> <rank> <world>
        <store>

runs ``<function>(payload, rank, world)`` in a group joined through the
file store ``<store>`` and pickles its result beside the payload (the
functions of another module through its own ``main``: ``start_ranks``'
``module``).  The rank processes import the port and never JAX."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_ranks(root, fn, payload, world=2,
                module='tests.torch_parallel_util'):
    """Start ``fn`` (a name in ``module``) on ``world`` ranks in ``root``;
    ``collect`` waits for them (the caller works meanwhile)."""
    root = str(root)
    path = os.path.join(root, fn + '.payload.pkl')
    with open(path, 'wb') as f:
        pickle.dump(payload, f)
    store = os.path.join(root, fn + '.store')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-m', module, fn, path,
         str(r), str(world), store], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs, [path + '.%d' % r for r in range(world)]


def collect(procs, outs, timeout=240):
    """The ranks' results in rank order.  A rank that fails, or a run past
    ``timeout`` seconds, stops every rank and fails the caller."""
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, 'rank %d (rc %s):\n%s' % (
            r, p.returncode, log[-4000:])
    results = []
    for out in outs:
        with open(out, 'rb') as f:
            results.append(pickle.load(f))
    return results


# -- run inside the rank processes --------------------------------------------

def _port(opt, variables):
    from captioning_tpu_torch.models.api import setup
    from tests.torch_port_util import tiny_vocab
    return setup(opt, tiny_vocab(), device='cpu').load_jax_variables(
        variables).replicate()


def _grads(pt):
    """The trainer's gradients as the JAX package's flat 'params/...'
    tree (numpy), as the clip sees them."""
    from captioning_tpu_torch.utils.weights import jax_from_state_dict
    return jax_from_state_dict({k: p.grad.clone() for k, p in
                                pt.named_params.items()},
                               pt.captioner.cfg, params_only=True)


def _record_first_grads(pt):
    """Keep the first step's gradients at the clip (after the all-reduce,
    before the clip changes them)."""
    seen = []
    clip = pt.clip

    def record(params):
        if not seen:
            seen.append(_grads(pt))
        return clip(params)
    pt.clip = record
    return seen


def _local_mean(pcap, pt, fc, att, labels, masks, am):
    """This rank's own mean loss and its gradient (what averaging per-rank
    means, as DDP does, would train on)."""
    import torch

    from captioning_tpu_torch.modules import losses
    logprobs = pcap.forward_tf(fc, att, labels[..., :-1], am, train=True,
                               ss_prob=0.0,
                               generator=torch.Generator().manual_seed(0))
    local = losses.language_model_criterion(logprobs, labels[..., 1:],
                                            masks[..., 1:])
    pt.optimizer.zero_grad(set_to_none=False)
    local.backward()
    return float(local), _grads(pt)


def xe_case(case, rank, world):
    """Two XE steps on this rank's rows of the global batch (and, with
    ``case['local']``, ``_local_mean`` first)."""
    import torch

    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.parallel import mesh
    pcap = _port(case['opt'], case['variables'])
    pt = Trainer(pcap, case['opt'])
    sl = mesh.local_batch_slice(case['fc'].shape[0])
    args = [torch.from_numpy(case[k][sl])
            for k in ('fc', 'att', 'labels', 'masks', 'am')]
    local = _local_mean(pcap, pt, *args) if case.get('local') else None
    seen = _record_first_grads(pt)
    got = [float(pt.xe_step(*args, case['lr'], 0.0,
                            torch.Generator().manual_seed(s),
                            drop_worst_flag=case['drop_worst'])['loss'])
           for s in range(2)]
    from captioning_tpu_torch.utils.misc import _flatten_tree
    stats = {k: v for k, v in _flatten_tree(pcap.jax_variables()).items()
             if k.startswith('batch_stats/')}
    return {'loss': got, 'grads': seen[0], 'local': local,
            'batch_stats': stats, 'route': pt.graph_route('xe')}


def _rl(case):
    """This rank's trainer (PPO's frozen old policy beside it), its images'
    arrays (``take``) and its rows of the global sampling noise
    (``draw``)."""
    import numpy as np
    import torch

    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.parallel import mesh
    old = case.get('old_variables')
    pt = Trainer(_port(case['opt'], case['variables']), case['opt'],
                 old_captioner=None if old is None else
                 _port(case['opt'], old))
    sl = mesh.local_batch_slice(case['fc'].shape[0])
    n = int(case['opt'].train_sample_n)
    rows = slice(sl.start * n, sl.stop * n)

    def draw(kind, t, shape):
        assert kind == 'gumbel'
        return torch.from_numpy(case['noise'][t][rows])

    def take(*names):
        return [torch.from_numpy(np.asarray(case[k][sl])) for k in names]
    return pt, sl, draw, take


def _rl_result(pt, out, seen, kind, **extra):
    """The step's reported scalars (global, so equal on every rank), its
    per-row arrays (this rank's rows) and the first gradients."""
    scalars = {k: float(v) for k, v in out.items() if v.dim() == 0}
    scalars.update(extra)
    rows = {k: v.numpy() for k, v in out.items() if v.dim() > 0}
    return {'loss': [scalars.pop('loss')], 'scalars': scalars,
            'rows': rows, 'grads': seen[0], 'route': pt.graph_route(kind)}


def sc_case(case, rank, world):
    """One fused SCST step on this rank's images."""
    import torch

    from captioning_tpu_torch.ops.cider_device import DeviceCiderD
    pt, _, draw, take = _rl(case)
    seen = _record_first_grads(pt)
    out = pt.sc_fused_step(*take('fc', 'att', 'am', 'refs', 'ref_mask'),
                           case['lr'], None, draw,
                           torch.Generator().manual_seed(0),
                           DeviceCiderD(case['df_path'], device='cpu'))
    return _rl_result(pt, out, seen, 'sc_fused')


def sc_grad_case(case, rank, world):
    """sc_decode on this rank's images, the host scorer's self-critical
    reward of its rows against their references, sc_grad_step; the
    reported reward is the global mean, as tools/train_torch.py takes
    it."""
    import torch

    from captioning_tpu_torch.parallel import mesh
    from captioning_tpu_torch.utils import rewards
    pt, sl, draw, take = _rl(case)
    rewards.init_scorer(case['df_path'])
    gen = torch.Generator().manual_seed(0)
    greedy, seq = pt.sc_decode(*take('fc', 'att', 'am'), None, draw, gen)
    reward = rewards.get_self_critical_reward(
        greedy.numpy(), case['gts'][sl], seq.numpy(), case['opt'])
    seen = _record_first_grads(pt)
    out = dict(pt.sc_grad_step(*take('fc', 'att', 'am'), seq,
                               torch.from_numpy(reward), case['lr'], gen),
               greedy=greedy, sampled=seq)
    return _rl_result(pt, out, seen, 'sc_grad', reward=mesh.global_mean(
        float(reward[:, 0].sum()), reward.shape[0]))


def struc_case(case, rank, world):
    """One fused structure-loss (or PPO) step on this rank's images."""
    import torch

    from captioning_tpu_torch.ops.cider_device import DeviceCiderD
    pt, _, draw, take = _rl(case)
    seen = _record_first_grads(pt)
    out = pt.struc_fused_step(
        *take('fc', 'att', 'labels', 'masks', 'am', 'refs', 'ref_mask'),
        case['lr'], draw, torch.Generator().manual_seed(0),
        torch.Generator().manual_seed(1),
        DeviceCiderD(case['df_path'], device='cpu'))
    return _rl_result(pt, out, seen, 'struc_fused')


def struc_grad_case(case, rank, world):
    """struc_decode on this rank's images, the host scores and self-CIDEr
    scores of its rows, struc_grad_step (with ``case['drop_worst']``)."""
    import torch

    from captioning_tpu_torch.utils import rewards
    pt, sl, draw, take = _rl(case)
    rewards.init_scorer(case['df_path'])
    gen = torch.Generator().manual_seed(0)
    seq = pt.struc_decode(*take('fc', 'att', 'am'), draw, gen)
    gts = case['gts'][sl]
    scores = rewards.get_scores(gts, seq.numpy(), case['opt'])
    sc = rewards.get_self_cider_scores(gts, seq.numpy(), case['opt'])
    seen = _record_first_grads(pt)
    out = pt.struc_grad_step(
        *take('fc', 'att', 'labels', 'masks', 'am'), seq,
        torch.from_numpy(scores), torch.from_numpy(sc), case['lr'], gen,
        torch.Generator().manual_seed(1),
        drop_worst_flag=case['drop_worst'])
    return _rl_result(pt, dict(out, sampled=seq), seen, 'struc_grad')


def train_cases(cases, rank, world):
    """Every case of ``cases`` ({name: case}) in turn."""
    fns = {'xe': xe_case, 'sc': sc_case, 'sc_grad': sc_grad_case,
           'struc': struc_case, 'struc_grad': struc_grad_case}
    return {name: fns[case['kind']](case, rank, world)
            for name, case in cases.items()}


class ArrayLoader:
    """The loader ``eval_split`` reads, over numpy arrays in memory: the
    images in order, ``batch_size`` a batch (the last one shorter), one
    pass a split."""

    def __init__(self, arrays, batch_size, vocab):
        self.arrays = arrays
        self.batch_size = batch_size
        self.vocab = vocab
        self.n = arrays['fc_feats'].shape[0]
        self.pos = 0

    def reset_iterator(self, split):
        self.pos = 0

    def get_vocab(self):
        return self.vocab

    def get_batch(self, split):
        sl = slice(self.pos, min(self.pos + self.batch_size, self.n))
        self.pos = sl.stop % self.n
        batch = {k: v[sl] for k, v in self.arrays.items()}
        batch['infos'] = [{'id': 100 + i, 'file_path': ''}
                          for i in range(sl.start, sl.stop)]
        batch['bounds'] = {'it_pos_now': sl.stop, 'it_max': self.n,
                           'wrapped': sl.stop == self.n}
        return batch


def eval_cases(cases, rank, world):
    """The cooperative ``eval_split`` of each case ({name: case}) for each
    of its ``kwargs``: {name: [(val loss, predictions)]}."""
    from captioning_tpu_torch.utils import eval_utils
    from tests.torch_port_util import tiny_vocab
    out = {}
    for name, case in cases.items():
        pcap = _port(case['opt'], case['variables'])
        out[name] = []
        for kwargs in case['kwargs']:
            loader = ArrayLoader(case['arrays'], case['batch_size'],
                                 tiny_vocab())
            loss, preds, _ = eval_utils.eval_split(pcap, loader, dict(kwargs))
            out[name].append((loss, preds))
    return out


def main(argv, names=None):
    """One rank: ``names[fn]`` (default this module's) run in the group."""
    import torch
    import torch.distributed as dist
    fn, path, rank, world, store = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    dist.init_process_group('gloo', init_method='file://' + store,
                            world_size=world, rank=rank)
    try:
        result = (names or globals())[fn](payload, rank, world)
    finally:
        dist.destroy_process_group()
    with open(path + '.%d' % rank, 'wb') as f:
        pickle.dump(result, f)


if __name__ == '__main__':
    main(sys.argv[1:])
