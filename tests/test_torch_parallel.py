"""The port's data axis (``captioning_tpu_torch/parallel``) on the CPU:

* the host copies against the JAX originals: ``local_batch_slice`` (7 and
  8 rows over 1-4 ranks, the remainder to the first ranks),
  ``object_allgather`` and ``gather_predictions`` (rank order, unequal
  sizes) over the thread-simulated allgather of tests/test_multihost.py
  (the port's take it as an object allgather, as
  ``dist.all_gather_object`` gathers);
* ``make_mesh`` / ``parse_mesh_shape``: the data axis, a model axis that
  needs data x model ranks, malformed shapes;
* the backend rule (gloo on the CPU, nccl with a GPU a rank, gloo where
  ranks share a card), how many ranks a launch starts, the options that
  join a group;
* the launcher: a failing rank fails the run and the other rank is
  stopped, not left waiting;
* a beam decode of one image (a rank's slice of a short batch) equals that
  image's row of a wider batch."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from captioning_tpu_torch.parallel import launch, mesh
from tests.test_multihost import LockstepAllgather, _run_processes


@pytest.mark.parametrize('size', [7, 8])
@pytest.mark.parametrize('n_proc', [1, 2, 3, 4])
def test_local_batch_slice_matches_jax(monkeypatch, size, n_proc):
    import jax

    from captioning_tpu.parallel.mesh import local_batch_slice
    monkeypatch.setattr(jax, 'process_count', lambda: n_proc)
    parts = []
    for i in range(n_proc):
        monkeypatch.setattr(jax, 'process_index', lambda p=i: p)
        got = mesh.local_batch_slice(size, n_proc, i)
        assert got == local_batch_slice(size)
        parts.append(np.arange(size)[got])
    assert (np.concatenate(parts) == np.arange(size)).all()
    sizes = [p.size for p in parts]
    assert sizes == sorted(sizes, reverse=True) and \
        max(sizes) - min(sizes) <= 1


def _preds(pid, n):
    return [{'image_id': 10 * pid + k, 'caption': 'cap %d %d' % (pid, k),
             'perplexity': float(k)} for k in range(n)]


@pytest.mark.parametrize('port', [False, True], ids=['jax', 'port'])
def test_object_allgather_and_gather_predictions_in_rank_order(port):
    """Unequal sizes (2, 0 and 3 predictions) over 3 simulated ranks: every
    rank gets every rank's list in rank order, from the port's copy as
    from the JAX original."""
    from captioning_tpu.parallel import mesh as jmesh
    impl = mesh if port else jmesh
    sizes = (2, 0, 3)
    comms = [LockstepAllgather(3), LockstepAllgather(3)]

    def gather(pid, k):
        arrays = comms[k].for_process(pid)
        if not port:
            return arrays

        def objects(obj):                # each object in a 0-d array
            box = np.empty((), object)
            box[()] = obj
            return list(arrays(box))
        return objects

    def fn(pid):
        objs = impl.object_allgather(_preds(pid, sizes[pid]), gather(pid, 0))
        merged = impl.gather_predictions(_preds(pid, sizes[pid]),
                                         _allgather=gather(pid, 1))
        return objs, merged
    out = _run_processes(3, fn)
    want = [_preds(p, n) for p, n in enumerate(sizes)]
    for objs, merged in out:
        assert objs == want
        assert merged == [e for chunk in want for e in chunk]


def test_one_rank_gathers_nothing():
    preds = _preds(0, 2)
    assert mesh.gather_predictions(preds) is preds
    assert mesh.broadcast_object({'a': 1}) == {'a': 1}
    x = torch.ones(3)
    assert mesh.all_reduce_sum(x) is x and mesh.all_reduce_grad(x) is x
    assert mesh.global_mean(3.0, 4.0) == 0.75
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == \
        (1, 0, True)


@pytest.mark.parametrize('shape', ['', 'data:1', 'data:1,model:1',
                                   ' data:1 '])
def test_make_mesh_one_rank(shape):
    m = mesh.make_mesh(shape)
    assert (m.world, m.rank) == (1, 0)


@pytest.mark.parametrize('shape,need', [('data:1,model:2', 2),
                                        ('data:2,model:2', 4),
                                        ('model:4', 4)])
def test_the_model_axis_raises(shape, need):
    """A model axis needs data x model ranks: one process (no group) is
    refused, naming the count."""
    with pytest.raises(ValueError, match='needs %d ranks, the process '
                       'group has 1' % need):
        mesh.make_mesh(shape)


@pytest.mark.parametrize('shape,err', [
    ('data:2', 'needs 2 ranks, the process group has 1'),
    ('pipe:2', 'expected'), ('data', 'expected'), ('data:x', 'expected')])
def test_make_mesh_rejects(shape, err):
    with pytest.raises(ValueError, match=err):
        mesh.make_mesh(shape)


@pytest.mark.parametrize('args,want', [
    (('cpu', 1, 2, 0), ('gloo', 'cpu')),
    (('cuda', 1, 2, 2), ('nccl', 'cuda:1')),
    (('cuda', 3, 8, 8), ('nccl', 'cuda:3')),
    (('cuda', 1, 2, 1), ('gloo', 'cuda:0')),
    (('cuda', 3, 4, 2), ('gloo', 'cuda:1'))])
def test_backend_rule(args, want):
    backend, dev = mesh.choose_backend(*args)
    assert (backend, str(dev)) == want


def test_backend_rule_without_a_gpu_raises():
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mesh.choose_backend('cuda', 0, 1, 0)


def _opt(**kw):
    base = dict(mesh_shape='', dist_coordinator='', dist_auto=0,
                dist_nproc=-1, dist_pid=-1, batch_size=6)
    return SimpleNamespace(**dict(base, **kw))


@pytest.mark.parametrize('kw,device,gpus,want', [
    ({}, 'cpu', 0, 1), ({'mesh_shape': 'data:2'}, 'cpu', 0, 2),
    ({'mesh_shape': 'data:3'}, 'cuda', 4, 3),
    ({}, 'cuda', 1, 1), ({}, 'cuda', 4, 3), ({'batch_size': 7}, 'cuda', 4, 1),
    ({'dist_coordinator': '127.0.0.1:1', 'mesh_shape': 'data:2'}, 'cpu', 0,
     1), ({'dist_auto': 1}, 'cuda', 4, 1),
    ({'mesh_shape': 'data:2,model:2'}, 'cpu', 0, 4),
    ({'mesh_shape': 'model:2'}, 'cuda', 2, 2)])
def test_ranks_a_launch_starts(monkeypatch, kw, device, gpus, want):
    """``--mesh_shape``'s data x model, else on several GPUs the largest
    count dividing the batch (tools/train.py ``_maybe_mesh``); a process
    given a group is one rank."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: gpus)
    assert launch.ranks_to_start(_opt(**kw), device) == want


def test_launch_refuses_more_ranks_than_gpus(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    with pytest.raises(ValueError, match='2 GPUs are visible'):
        launch.ranks_to_start(_opt(mesh_shape='data:4'), 'cuda')
    with pytest.raises(ValueError, match='4 ranks, one a GPU, but 2 GPUs'):
        launch.ranks_to_start(_opt(mesh_shape='data:2,model:2'), 'cuda')


def test_init_distributed_options(monkeypatch):
    """No option: one process, no group.  ``--dist_coordinator`` without
    its count and id, and ``--dist_auto`` outside torchrun, raise."""
    assert mesh.init_distributed(_opt(), 'cpu') == 'cpu'
    assert mesh.world_size() == 1
    with pytest.raises(ValueError, match='--dist_nproc'):
        mesh.init_distributed(_opt(dist_coordinator='127.0.0.1:1'), 'cpu')
    for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match='torchrun'):
        mesh.init_distributed(_opt(dist_auto=1), 'cpu')


RANK_SCRIPT = '''
import sys, time
pid = int(sys.argv[sys.argv.index('--dist_pid') + 1])
if pid == 1:
    sys.exit(3)
time.sleep(120)
'''


def test_a_failing_rank_fails_the_run_and_stops_the_others(tmp_path):
    script = tmp_path / 'rank.py'
    script.write_text(RANK_SCRIPT)
    t = time.time()
    assert launch.run_ranks(str(script), [], 2) == 3
    assert time.time() - t < 60


def test_beam_of_one_image_equals_its_row_of_a_wider_batch():
    """A rank's slice of a short global batch may hold one image: the
    transformer's beam decode there (whose fused candidates are broadcast
    from the bos step) equals that image's row of a batch of three."""
    from captioning_tpu_torch.models.api import setup
    from tests.torch_port_util import inputs, tiny_opt, tiny_vocab
    cap = setup(tiny_opt(N_enc=1, N_dec=1), tiny_vocab(), device='cpu')
    cap.init_params(torch.Generator().manual_seed(1))
    fc, att, am = (torch.from_numpy(a) for a in inputs(3))
    opt = {'beam_size': 3, 'sample_method': 'greedy'}
    wide, _, _ = cap.sample_beam(fc, att, am, None, opt)
    one, _, _ = cap.sample_beam(fc[1:2], att[1:2], am[1:2], None, opt)
    assert torch.equal(one[0], wide[1])
