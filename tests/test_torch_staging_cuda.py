"""``utils.staging`` on the card: the staged tensors against
``torch.as_tensor(x, dtype).to('cuda')`` bit for bit while the compute
stream is busy, and one pinned ring a process across ``eval_split`` calls.
Marked ``chip``; each test skips without a CUDA device.  On the card,
from the repo root (the suite's conftest needs JAX, which the card's
machine does not have)::

    python -m pytest --noconftest -q -m chip tests/test_torch_staging_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from captioning_tpu_torch.utils import eval_utils, staging  # noqa: E402

pytestmark = pytest.mark.chip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card')
    return torch.device('cuda', torch.cuda.current_device())


def _arrays(seed=0):
    """Sized not to fill the ring's last chunk."""
    rng = np.random.RandomState(seed)
    return {
        'att': (rng.randn(1000, 36, 2048).astype(np.float32), torch.float32),
        'small': (rng.randn(7, 3, 5).astype(np.float32), torch.float32),
        'labels': (rng.randint(0, 2 ** 40, (1000, 5, 18)), torch.long),
        'labels32': (rng.randint(0, 9488, (1000, 5, 18)).astype(np.int32),
                     torch.long),
        'none': (None, torch.float32),
    }


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_staged_bytes_equal_as_tensor_under_a_busy_stream(cuda):
    arrays = _arrays()
    assert arrays['att'][0].nbytes % staging.CHUNK_BYTES != 0
    a = torch.randn(4096, 4096, device=cuda)
    for _ in range(3):
        # the compute stream holds a kernel loop while the copy is staged
        b = a
        for _ in range(40):
            b = torch.tanh(b @ a)
        got = staging.Stage(arrays, cuda).wait()
        for k, (x, dtype) in arrays.items():
            if x is None:
                assert got[k] is None
                continue
            want = torch.as_tensor(x, dtype=dtype).to(cuda)
            assert got[k].device == want.device
            assert got[k].dtype == want.dtype and got[k].shape == want.shape
            assert torch.equal(_bits(got[k]), _bits(want)), k
        torch.cuda.synchronize()
        assert torch.isfinite(b).all()
    ring = staging._RINGS[(os.getpid(), str(cuda))]
    assert ring.stream != torch.cuda.current_stream(cuda)
    assert ring.chunks and all(c.is_pinned() for c in ring.chunks)


class _Stub:
    """What ``eval_split`` calls of a captioner, on the card: a 'decode'
    whose tokens are read from the features (so a wrong copy shows), and
    no graph route."""

    def __init__(self, device):
        self.device = device
        self.vocab = {str(i): 'w%d' % i for i in range(1, 30)}

    def graph_route(self, kind, opt):
        return 'eager'

    def sample_beam(self, fc, att, am, rng, opt):
        seq = (att[:, :4, 0].abs() * 10).long().clamp(1, 29)
        stats = {'ent_sum': att[:, 0, 1].double(),
                 'lp_sum': -att[:, 0, 2].abs().double()}
        return seq, stats, None

    sample_stats = sample_beam


class _Loader:
    def __init__(self, att):
        self.att, self.n, self.batch, self.pos = att, att.shape[0], 400, 0

    def reset_iterator(self, split):
        self.pos = 0

    def get_vocab(self):
        return {str(i): 'w%d' % i for i in range(1, 30)}

    def get_batch(self, split):
        a, b = self.pos, min(self.pos + self.batch, self.n)
        self.pos = 0 if b >= self.n else b
        return {'fc_feats': self.att[a:b].mean(1), 'att_feats': self.att[a:b],
                'att_masks': np.ones(self.att[a:b].shape[:2], np.float32),
                'labels': None, 'masks': None,
                'infos': [{'id': i, 'file_path': ''} for i in range(a, b)],
                'bounds': {'it_pos_now': self.pos, 'it_max': self.n,
                           'wrapped': b >= self.n}}


def test_one_ring_across_eval_split_calls(cuda, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    made = []
    init = staging._Ring.__init__

    def counting(ring, device):
        made.append(device)
        init(ring, device)

    monkeypatch.setattr(staging._Ring, '__init__', counting)
    monkeypatch.setattr(staging, '_RINGS', {})
    att = np.random.RandomState(1).randn(1000, 36, 2048).astype(np.float32)
    kw = dict(beam_size=3, num_images=1000, split='test', verbose=False)
    on_card = eval_utils.eval_split(_Stub(cuda), _Loader(att), kw)[1]
    for _ in range(2):
        assert eval_utils.eval_split(_Stub(cuda), _Loader(att),
                                     kw)[1] == on_card
    assert made == [cuda]
    on_cpu = eval_utils.eval_split(_Stub(torch.device('cpu')), _Loader(att),
                                   kw)[1]
    assert on_card == on_cpu
