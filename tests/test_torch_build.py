"""The kernels' build and launch guards, on a machine without nvcc or a
GPU: a missing compiler raises (there is no fallback), libraries are keyed
by the source's hash, and a tensor that is not on the CPU never reaches a
plain twin (the ``meta`` device stands in for a CUDA one here)."""

import ctypes
import os
import re

import pytest
import torch

from captioning_tpu_torch.ops import _build
from captioning_tpu_torch.ops.attention import additive_attention_fused
from captioning_tpu_torch.ops.beam_attend import (attend_merged,
                                                 attend_write_merged)
from captioning_tpu_torch.ops.logit_topk import logit_topk
from captioning_tpu_torch.ops.lstm import maxout_lstm_gates_fused
from captioning_tpu_torch.ops.topk import topk_lastdim


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'kernels'))
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no_cuda'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build('beam_attend')


@pytest.mark.parametrize('name', ['beam_attend', 'logit_topk',
                                  'additive_attention', 'maxout_lstm',
                                  'topk', 'attend'])
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
    with pytest.raises(ValueError, match='CUDA'):
        attend_merged(q, k, v, anc, 3, bw=5, h=4)
    with pytest.raises(ValueError, match='CUDA'):
        attend_merged(q, k, v, None, 7, bw=1, h=4)
    w, b = torch.empty(50, D, **meta), torch.empty(50, **meta)
    with pytest.raises(ValueError, match='CUDA'):
        logit_topk(q, w, b, k=5)
    assert attend_write_merged.launches == 0 and logit_topk.launches == 0
    assert attend_merged.launches == 0


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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_non_cpu_tensors_never_take_the_maxout_twin(dtype):
    meta = dict(device='meta', dtype=dtype)
    with pytest.raises(ValueError, match='CUDA'):
        maxout_lstm_gates_fused(torch.empty(6, 40, **meta),
                                torch.empty(6, 8, **meta))
    assert maxout_lstm_gates_fused.launches == 0


@pytest.mark.parametrize('k', [1, 5, 16])
def test_non_cpu_tensors_never_take_the_topk_twin(k):
    with pytest.raises(ValueError, match='CUDA'):
        topk_lastdim(torch.empty(4, 5 * 37, device='meta'), k)
    assert topk_lastdim.launches == 0


def test_every_source_has_a_signature():
    """Each csrc/*.cu is bound: ``_build.load`` sets argtypes from
    SIGNATURES, so a source without an entry could not be called."""
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith('.cu'))
    assert sources == sorted(_build.SIGNATURES)


_CTYPES = {'void*': ctypes.c_void_p, 'int': ctypes.c_int,
           'float': ctypes.c_float}


@pytest.mark.parametrize('name', sorted(_build.SIGNATURES))
def test_signatures_match_the_sources(name):
    """Each ``extern "C"`` entry point of ``csrc/<name>.cu`` has the
    argtypes that SIGNATURES binds, in order (a mismatch would pass
    pointers as ints or shift the arguments, and no compiler here sees
    it)."""
    with open(os.path.join(_build.CSRC, name + '.cu')) as f:
        src = f.read()
    found = {}
    for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[fn] = [_CTYPES[re.sub(r'\s+', '', ' '.join(p.split()[:-1]))]
                     for p in params.split(',')]
    assert found == _build.SIGNATURES[name]
    if name == 'attend':
        assert sorted(found) == ['anc_attend', 'attend_merged', 'mha_step']


def test_libraries_link_after_the_source(tmp_path, monkeypatch):
    """libcuda (the TMA descriptors' encoder) is named after the
    source, so a linker that drops unneeded libraries keeps it; the
    build raises when nvcc fails."""
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'kernels'))
    monkeypatch.setattr(_build, '_nvcc', lambda: 'nvcc')
    seen = []

    class Failed:
        returncode, stdout, stderr = 1, '', 'no'

    def run(cmd, **kw):
        seen.append(cmd)
        return Failed()
    monkeypatch.setattr(_build.subprocess, 'run', run)
    with pytest.raises(RuntimeError, match='nvcc failed for logit_topk.cu'):
        _build.build('logit_topk')
    cmd = seen[0]
    src = cmd.index(os.path.join(_build.CSRC, 'logit_topk.cu'))
    assert '-lcuda' in cmd and cmd.index('-lcuda') > src
    assert cmd[1:1 + len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS


def test_library_is_keyed_by_the_link_libraries(monkeypatch):
    path = _build.library_path('logit_topk')
    monkeypatch.setattr(_build, 'NVCC_LIBS', [])
    assert _build.library_path('logit_topk') != path


def test_non_cpu_tensors_never_take_the_tanh_twin():
    from captioning_tpu_torch.ops.attention import tanh_table_rule
    with pytest.raises(ValueError, match='CUDA'):
        tanh_table_rule(torch.empty(8, dtype=torch.bfloat16, device='meta'))
    with pytest.raises(TypeError, match='bf16'):
        tanh_table_rule(torch.empty(8))


# ---------------------------------------------------------------------------
# The strided attend's vector width: each wrapper of csrc/attend.cu refuses a
# tensor off the width its kernel loads at (vector_bytes of the head's
# bytes) and passes an aligned one on.  ``meta`` tensors stand in for CUDA
# ones, with ``is_cuda`` faked on the Tensor class and a library that
# records its calls in place of the built one.
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        return lambda *args: self.calls.append((fn, args)) or 0


@pytest.fixture
def fake_attend(monkeypatch):
    from captioning_tpu_torch.ops import anc_attend, beam_attend, mha_step
    lib = _Recorder()
    monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda x: True))
    monkeypatch.setattr(_build, 'load', lambda name: lib)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 0)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: False)
    for fn in (beam_attend.attend_merged, mha_step.mha_step_fused,
               anc_attend.anc_attend):
        monkeypatch.setattr(fn, 'launches', 0)
    return lib


def _meta(shape, dtype, offset_bytes=0):
    """A ``meta`` tensor starting ``offset_bytes`` past an aligned base."""
    n, es = 1, torch.empty(0, dtype=dtype).element_size()
    for s in shape:
        n *= s
    flat = torch.empty(n + 64, device='meta', dtype=dtype)
    return flat[offset_bytes // es:offset_bytes // es + n].view(shape)


def _attend_call(name, dk, dtype, shift):
    """Call wrapper ``name`` at head width ``dk``, its first tensor starting
    ``shift`` bytes off an aligned base; returns the expected ints the
    kernel gets."""
    from captioning_tpu_torch.ops.anc_attend import anc_attend
    from captioning_tpu_torch.ops.beam_attend import attend_merged
    from captioning_tpu_torch.ops.mha_step import mha_step_fused
    N, h, T, bw = 10, 2, 9, 5
    code = _build.dtype_code(dtype)
    anc = torch.zeros(N, T, dtype=torch.int32, device='meta')
    if name == 'attend_merged':
        D = h * dk
        attend_merged(_meta((N, D), dtype, shift), _meta((N, T, D), dtype),
                      _meta((N, T, D), dtype), anc, 4, bw=bw, h=h)
        return [N, T, D, h, bw, 4, code]
    if name == 'mha_step':
        mha_step_fused(_meta((N, h, dk), dtype, shift),
                       *(_meta((N, h, dk), dtype) for _ in range(2)),
                       *(_meta((N, h, T, dk), dtype) for _ in range(2)), 4)
        return [N, h, T, dk, 4, code]
    L = 3
    anc_attend(_meta((N, L, h, T, dk), dtype, shift),
               _meta((N, L, h, T, dk), dtype), _meta((N, h * dk), dtype),
               anc, 2, 4, bw)
    return [N, L, h, T, dk, 2, 4, bw, code]


@pytest.mark.parametrize('name', ['attend_merged', 'mha_step', 'anc_attend'])
@pytest.mark.parametrize('dk', [64, 10, 254])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_attend_wrappers_check_the_kernel_vector_width(fake_attend, name, dk,
                                                       dtype):
    from captioning_tpu_torch.ops.beam_attend import vector_bytes
    vb = vector_bytes(dk * torch.empty(0, dtype=dtype).element_size())
    assert vb == {(64, torch.float32): 16, (64, torch.bfloat16): 16,
                  (10, torch.float32): 8, (10, torch.bfloat16): 4,
                  (254, torch.float32): 8, (254, torch.bfloat16): 4}[
                      (dk, dtype)]
    # half a vector off: refused before the library is reached
    with pytest.raises(ValueError, match='%d-byte boundary' % vb):
        _attend_call(name, dk, dtype, vb // 2)
    assert fake_attend.calls == []
    # a whole vector off is aligned: the kernel gets the call
    want = _attend_call(name, dk, dtype, vb)
    (fn, args), = fake_attend.calls
    ints = [a for a, ty in zip(args, _build.SIGNATURES['attend'][fn])
            if ty is ctypes.c_int]
    assert fn == name and ints == want


@pytest.mark.parametrize('name', ['attend_merged', 'mha_step', 'anc_attend'])
@pytest.mark.parametrize('capturing', [False, True])
def test_attend_wrappers_count_launches_not_captures(fake_attend, monkeypatch,
                                                     name, capturing):
    """Each launch adds one to the wrapper's counter; a call that a CUDA
    graph captures reaches the kernel's entry point but adds nothing."""
    from captioning_tpu_torch.ops import anc_attend, beam_attend, mha_step
    fn = {'attend_merged': beam_attend.attend_merged,
          'mha_step': mha_step.mha_step_fused,
          'anc_attend': anc_attend.anc_attend}[name]
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: capturing)
    _attend_call(name, 64, torch.bfloat16, 0)
    assert [c[0] for c in fake_attend.calls] == [name]
    assert fn.launches == (0 if capturing else 1)


@pytest.mark.parametrize('dk', [64, 10, 254])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_anc_attend_layer_offset_keeps_the_vector_width(dk, dtype):
    """``anc_attend`` reads layer l at K + l * h * T * dk elements: every
    layer of an aligned stack starts on the kernel's vector width."""
    from captioning_tpu_torch.ops.beam_attend import vector_bytes
    vb = vector_bytes(dk * torch.empty(0, dtype=dtype).element_size())
    K = _meta((4, 6, 3, 7, dk), dtype)
    for l in range(6):
        assert K[:, l].data_ptr() % vb == 0
