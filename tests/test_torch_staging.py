"""``utils.staging`` and the ``eval_split`` loop around it, on the CPU: the
loader's calls, the predictions and val loss against each batch alone,
the spans and counters, errors in the copy's worker and in the strings.

Each eval test runs twice: ``cpu`` is the CPU branch the port takes on
the CPU (the copy on the caller's thread), ``worker`` runs the CUDA
branch's ring and worker thread on the CPU with chunks of 64 bytes, so
that every array spans several chunks."""

import threading
import time

import numpy as np
import pytest
import torch

from captioning_tpu_torch.models.api import setup
from captioning_tpu_torch.modules import losses
from captioning_tpu_torch.utils import eval_utils, staging, tracing
from tests.torch_port_util import (inputs, tiny_opt, tiny_rnn_opt,
                                   tiny_vocab, train_batch)

ROUTES = {'beam': {'beam_size': 3}, 'stats': {'beam_size': 1},
          'slow': {'beam_size': 1, 'group_size': 2}}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(params=['cpu', 'worker'])
def pipe(request, monkeypatch):
    """'worker': the ring and the worker thread on the CPU."""
    if request.param == 'worker':
        monkeypatch.setattr(staging, 'pipelined', lambda device: True)
        monkeypatch.setattr(staging, 'CHUNK_BYTES', 64)
        monkeypatch.setattr(staging, '_RINGS', {})
    return request.param


def _captioner(model='transformer', seed=0):
    opt = tiny_opt() if model == 'transformer' else tiny_rnn_opt(model)
    return setup(opt, tiny_vocab(), 'cpu').init_params(
        torch.Generator().manual_seed(seed))


class _Loader:
    """A split of ``n`` images (``first`` the first one's id) in batches
    of ``batch``; with ``labels`` also labels and masks [B, 2, 8] (int32,
    as an h5 file holds them).  Counts its calls and their threads, and
    fails a call that would read past the split's end."""

    def __init__(self, n, batch, seed=0, labels=False, first=0):
        self.fc, self.att, self.am = inputs(B=n, seed=seed)
        self.labels = self.masks = None
        if labels:
            lab, self.masks = train_batch(B=n, spi=2, seed=seed)
            self.labels = lab.astype(np.int32)
        self.n, self.batch, self.first = n, batch, first
        self.pos, self.calls, self.threads = 0, 0, set()

    def reset_iterator(self, split):
        self.pos = 0

    def get_vocab(self):
        return tiny_vocab()

    def get_batch(self, split):
        assert self.pos < self.n, 'get_batch past the split'
        self.calls += 1
        self.threads.add(threading.get_ident())
        a, b = self.pos, min(self.pos + self.batch, self.n)
        self.pos = 0 if b >= self.n else b
        pick = lambda x: None if x is None else x[a:b]
        return {'fc_feats': self.fc[a:b], 'att_feats': self.att[a:b],
                'att_masks': self.am[a:b], 'labels': pick(self.labels),
                'masks': pick(self.masks),
                'infos': [{'id': self.first + i, 'file_path': ''}
                          for i in range(a, b)],
                'bounds': {'it_pos_now': self.pos, 'it_max': self.n,
                           'wrapped': b >= self.n}}

    def part(self, a, b):
        """A loader of images [a, b) alone, in one batch."""
        out = _Loader(b - a, b - a, first=a)
        out.fc, out.att, out.am = self.fc[a:b], self.att[a:b], self.am[a:b]
        return out


def _kw(route='beam', **kw):
    return dict(ROUTES[route], split='test', verbose=False, suppress_UNK=1,
                max_length=6, id='st', **kw)


@pytest.mark.parametrize('n,batch,num_images,calls,pos', [
    (10, 4, -1, 3, 0), (10, 4, 10, 3, 0), (10, 4, 7, 2, 8),
    (8, 4, 8, 2, 0), (10, 4, 4, 1, 4), (3, 4, -1, 1, 0)])
def test_get_batch_once_a_batch_from_the_callers_thread(
        pipe, n, batch, num_images, calls, pos):
    cap, loader = _captioner(), _Loader(n, batch)
    for k in range(1, 3):              # two passes, each from the start
        preds = eval_utils.eval_split(cap, loader,
                                      _kw(num_images=num_images))[1]
        assert loader.calls == k * calls
        assert loader.pos == pos
        assert len(preds) == (n if num_images == -1 else num_images)
    assert loader.threads == {threading.get_ident()}


@pytest.mark.parametrize('model', ['transformer', 'updown'])
@pytest.mark.parametrize('route', sorted(ROUTES))
def test_predictions_equal_each_batch_alone(pipe, model, route):
    cap, loader = _captioner(model), _Loader(10, 4)
    kw = _kw(route, num_images=10)
    got = eval_utils.eval_split(cap, loader, kw)[1]
    alone = []
    for a in range(0, 10, 4):
        b = min(a + 4, 10)
        alone += eval_utils.eval_split(cap, loader.part(a, b),
                                       dict(kw, num_images=b - a))[1]
    assert [p['image_id'] for p in got] == list(range(10))
    assert got == alone


def test_num_images_cutting_a_batch_keeps_the_first_predictions(pipe):
    cap = _captioner()
    whole = eval_utils.eval_split(cap, _Loader(10, 4), _kw(num_images=10))[1]
    cut = eval_utils.eval_split(cap, _Loader(10, 4), _kw(num_images=7))[1]
    assert cut == whole[:7]


@pytest.mark.parametrize('label_smoothing', [0.0, 0.2])
def test_val_loss_equals_the_serial_loop(pipe, label_smoothing):
    cap, loader = _captioner(), _Loader(10, 4, labels=True)
    kw = _kw(num_images=10, label_smoothing=label_smoothing)
    val_loss = eval_utils.eval_split(cap, loader, kw)[0]
    total, batches = 0.0, 0
    for a in range(0, 10, 4):
        sl = slice(a, a + 4)
        fc, att, am = (torch.as_tensor(x[sl], dtype=torch.float32)
                       for x in (loader.fc, loader.att, loader.am))
        labels = torch.as_tensor(loader.labels[sl], dtype=torch.long)
        masks = torch.as_tensor(loader.masks[sl], dtype=torch.float32)
        logprobs = cap.forward_tf(fc, att, labels[..., :-1], am)
        if label_smoothing > 0:
            loss = losses.label_smoothing_criterion(
                logprobs, labels[..., 1:], masks[..., 1:], label_smoothing)
        else:
            loss = losses.language_model_criterion(
                logprobs, labels[..., 1:], masks[..., 1:])
        total += float(loss)
        batches += 1
    assert val_loss == total / (1e-8 + batches)


@pytest.mark.parametrize('labels', [False, True])
def test_spans_and_counters_once_a_batch(pipe, labels):
    n, batch = 10, 4
    cap, loader = _captioner(), _Loader(n, batch, labels=labels)
    eval_utils.eval_split(cap, loader, _kw(num_images=n))
    batches = -(-n // batch)
    for name in ('eval.load', 'eval.h2d', 'eval.decode', 'eval.post'):
        assert len(tracing.intervals(name)) == batches, name
    floats = n * (10 + 5 * 12 + 5) * 4
    if labels:              # int64 labels and float32 masks, [n, 2, 8]
        floats += n * 2 * 8 * (8 + 4)
    counts = tracing.counters()
    assert counts['eval.h2d_bytes'] == floats
    assert 0 <= counts['eval.h2d_hidden'] <= batches
    stages = tracing.intervals('eval.stage')
    assert len(stages) == (batches if pipe == 'worker' else 0)
    assert all(a <= b for a, b in stages)


def test_a_finished_copy_counts_hidden(pipe):
    x = np.arange(100, dtype=np.float32)
    stage = staging.Stage({'x': (x, torch.float32)}, 'cpu')
    if stage.future is not None:
        stage.future.result(timeout=30)
    stage.wait()
    assert stage.hidden == (pipe == 'worker')


def test_a_copy_still_running_does_not_count_hidden(pipe, monkeypatch):
    go = threading.Event()
    stage_fn = staging._Ring.stage

    def slow(ring, dsts, srcs, done):
        assert go.wait(30)
        return stage_fn(ring, dsts, srcs, done)

    monkeypatch.setattr(staging._Ring, 'stage', slow)
    stage = staging.Stage({'x': (np.ones(50, np.float32), torch.float32)},
                           'cpu')
    threading.Timer(0.2, go.set).start()
    assert torch.equal(stage.wait()['x'], torch.ones(50))
    assert not stage.hidden
    go.set()


def _arrays():
    rng = np.random.RandomState(3)
    strided = rng.randn(6, 10).astype(np.float32)[:, ::3]
    return {
        'att': (rng.randn(5, 3, 7).astype(np.float32), torch.float32),
        'odd': (rng.randn(7, 3, 5).astype(np.float32), torch.float32),
        'f64': (rng.randn(4, 9), torch.float32),
        'labels': (rng.randint(0, 10 ** 6, (6, 2, 9)).astype(np.int32),
                   torch.long),
        'strided': (strided, torch.float32),
        'empty': (np.zeros((0, 4), np.float32), torch.float32),
        'none': (None, torch.float32),
    }


def test_staged_tensors_equal_as_tensor(pipe):
    arrays = _arrays()
    got = staging.Stage(arrays, 'cpu').wait()
    for k, (x, dtype) in arrays.items():
        if x is None:
            assert got[k] is None
            continue
        want = torch.as_tensor(x, dtype=dtype)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        assert torch.equal(got[k], want), k


def test_nothing_to_copy(pipe):
    got = staging.Stage({'empty': (np.zeros((0, 3), np.float32),
                                    torch.float32),
                          'none': (None, torch.long)}, 'cpu').wait()
    assert got['none'] is None and got['empty'].shape == (0, 3)


def test_the_ring_is_made_once_a_device(pipe, monkeypatch):
    made = []
    init = staging._Ring.__init__

    def counting(ring, device):
        made.append(device)
        init(ring, device)

    monkeypatch.setattr(staging._Ring, '__init__', counting)
    cap, loader = _captioner(), _Loader(10, 4)
    chunks = []
    for _ in range(3):
        eval_utils.eval_split(cap, loader, _kw(num_images=10))
        chunks.append([c.data_ptr() for r in staging._RINGS.values()
                       for c in r.chunks])
    if pipe == 'cpu':
        assert made == [] and chunks == [[]] * 3
        return
    assert made == [torch.device('cpu')]
    # a batch of 4: fc 160 bytes in chunks 0-2, the masks 80 from the
    # next 64-byte boundary in 3-4, att 960 in 5-19
    assert len(chunks[0]) == 20
    assert chunks[0] == chunks[1] == chunks[2]


def _failing_at(monkeypatch, calls, wrap):
    """``_Ring.stage`` with ``wrap(n, run)`` around its n-th call."""
    stage_fn = staging._Ring.stage

    def stage(ring, dsts, srcs, done):
        calls.append(len(calls))
        return wrap(len(calls), lambda: stage_fn(ring, dsts, srcs, done))

    monkeypatch.setattr(staging._Ring, 'stage', stage)


def test_a_worker_error_reaches_the_caller(pipe, monkeypatch):
    calls = []

    def second_fails(n, run):
        if n == 2:
            raise RuntimeError('staging failed')
        return run()

    _failing_at(monkeypatch, calls, second_fails)
    loader = _Loader(10, 4)
    if pipe == 'cpu':                  # no worker: nothing to fail
        eval_utils.eval_split(_captioner(), loader, _kw(num_images=10))
        assert calls == []
        return
    with pytest.raises(RuntimeError, match='staging failed'):
        eval_utils.eval_split(_captioner(), loader, _kw(num_images=10))
    assert loader.calls == 2
    assert len(tracing.intervals('eval.decode')) == 1
    # the ring takes the next stage after a failed one
    staging.Stage({'x': (np.ones(3, np.float32), torch.float32)},
                   'cpu').wait()


def test_an_error_in_the_strings_waits_for_the_pending_copy(pipe,
                                                             monkeypatch):
    """Batch 1's copy is in flight when the strings of batch 0 raise:
    ``eval_split`` returns only once that copy has ended."""
    calls, ended = [], []

    def second_slow(n, run):
        if n == 2:
            time.sleep(0.3)
        out = run()
        ended.append(n)
        return out

    def broken(*args):
        raise ValueError('strings failed')

    _failing_at(monkeypatch, calls, second_slow)
    monkeypatch.setattr(eval_utils, '_stats_from_sums', broken)
    loader = _Loader(10, 4)
    with pytest.raises(ValueError, match='strings failed'):
        eval_utils.eval_split(_captioner(), loader, _kw(num_images=10))
    assert loader.calls == 2
    # both batches' copies had ended before the call returned
    assert ended == ([1, 2] if pipe == 'worker' else [])
