"""The kernels' build and launch guards, on a machine without nvcc or a
GPU: a missing compiler raises (there is no fallback), libraries are keyed
by the source's hash, and a tensor that is not on the CPU never reaches a
plain twin (the ``meta`` device stands in for a CUDA one here)."""

import os

import pytest
import torch

from captioning_tpu_torch.ops import _build
from captioning_tpu_torch.ops.attention import additive_attention_fused
from captioning_tpu_torch.ops.beam_attend import attend_write_merged
from captioning_tpu_torch.ops.logit_topk import logit_topk


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'kernels'))
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no_cuda'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build('beam_attend')


@pytest.mark.parametrize('name', ['beam_attend', 'logit_topk',
                                  'additive_attention'])
def test_library_is_keyed_by_source_hash(name, tmp_path, monkeypatch):
    path = _build.library_path(name)
    assert os.path.basename(path).startswith(name + '-')
    src = tmp_path / (name + '.cu')
    with open(os.path.join(_build.CSRC, name + '.cu')) as f:
        src.write_text(f.read() + '\n// edited\n')
    monkeypatch.setattr(_build, 'CSRC', str(tmp_path))
    assert _build.library_path(name) != path


def test_non_cpu_tensors_never_take_the_twins():
    meta = dict(device='meta')
    N, T, D = 10, 8, 32
    q = torch.empty(N, D, **meta)
    k, v = torch.empty(N, T, D, **meta), torch.empty(N, T, D, **meta)
    anc = torch.zeros(N, T, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match='CUDA'):
        attend_write_merged(q, k, v, q, q, anc, 3, bw=5, h=4)
    w, b = torch.empty(50, D, **meta), torch.empty(50, **meta)
    with pytest.raises(ValueError, match='CUDA'):
        logit_topk(q, w, b, k=5)
    assert attend_write_merged.launches == 0 and logit_topk.launches == 0


@pytest.mark.parametrize('bw', [1, 5])
@pytest.mark.parametrize('masked', [False, True])
def test_non_cpu_tensors_never_take_the_attention_twin(bw, masked):
    meta = dict(device='meta')
    nb, M, H, A = 4, 6, 10, 8
    att_h = torch.empty(nb * bw, A, **meta)
    att, p_att = torch.empty(nb, M, H, **meta), torch.empty(nb, M, A, **meta)
    mask = torch.ones(nb, M, **meta) if masked else None
    with pytest.raises(ValueError, match='CUDA'):
        additive_attention_fused(att_h, att, p_att, mask,
                                 torch.empty(A, **meta),
                                 torch.empty(1, **meta))
    assert additive_attention_fused.launches == 0


def test_every_source_has_a_signature():
    """Each csrc/*.cu is bound: ``_build.load`` sets argtypes from
    SIGNATURES, so a source without an entry could not be called."""
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith('.cu'))
    assert sources == sorted(_build.SIGNATURES)
