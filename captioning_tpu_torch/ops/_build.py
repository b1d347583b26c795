"""Build the CUDA sources in ``csrc/`` at first use and bind them.

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface under ``<repo>/build/kernels/``, named by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads.
The libraries are bound with ``ctypes``: every pointer and the stream are
``c_void_p``, every size an ``c_int``, and each entry point returns
``cudaGetLastError()`` after its launch.  A failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import torch

from ..utils import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']
# after the source, so the linker keeps them: libcuda encodes the TMA
# descriptors (cuTensorMapEncodeTiled)
NVCC_LIBS = ['-lcuda']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes (each returns cudaError_t as int)
SIGNATURES = {
    'additive_attention': {
        # att_h, att, p_att, mask, w, b, out, nb, bw, M, H, A, dtype,
        # att_dtype, stream
        'additive_attention': [_P] * 7 + [_I] * 7 + [_P],
        # x, y, n, stream: the kernel's bf16 tanh rule, for its check
        'additive_attention_tanh': [_P, _P, _I, _P],
    },
    'attend': {
        # q, k, v, anc, ctx, N, T, D, h, bw, t0, dtype, stream
        'attend_merged': [_P] * 5 + [_I] * 7 + [_P],
        # q, k_new, v_new, k_cache, v_cache, out, N, h, T, dk, t, dtype,
        # stream
        'mha_step': [_P] * 6 + [_I] * 6 + [_P],
        # K, V, q, anc, out, N, L, h, T, dk, l, t, bw, dtype, stream
        'anc_attend': [_P] * 5 + [_I] * 9 + [_P],
    },
    'beam_attend': {
        # q, k_cache, v_cache, k_new, v_new, anc, ctx,
        # N, Tp, D, h, bw, t0, dtype, stream
        'attend_write_merged': [_P] * 7 + [_I] * 7 + [_P],
    },
    'maxout_lstm': {
        # s, c_prev, h, c, N, H, dtype, stream
        'maxout_lstm_gates': [_P] * 4 + [_I] * 3 + [_P],
    },
    'topk': {
        # x, vals, idx, B, C, k, stream
        'topk_lastdim': [_P] * 3 + [_I] * 3 + [_P],
    },
    'logit_topk': {
        # x, w, b, ws_f, ws_i, out_vals, out_idx, out_rowsum, out_ent,
        # N, D, V1, k, unk_idx, splits, v_off, merge, temp, unk_bias,
        # dtype, stream
        'logit_topk': [_P] * 9 + [_I] * 8 + [_F, _F, _I, _P],
        # ws_f, ws_i, out_vals, out_idx, out_rowsum, out_ent, N, V1, k,
        # parts, stream
        'logit_topk_merge_parts': [_P] * 6 + [_I] * 4 + [_P],
    },
}

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    if not os.path.isfile(path):
        raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin); the CUDA '
                           'kernels of captioning_tpu_torch cannot be built')
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(
            f.read() + ' '.join(NVCC_FLAGS + NVCC_LIBS).encode())
    return os.path.join(BUILD_DIR, '%s-%s.so' % (name,
                                                 digest.hexdigest()[:16]))


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = ([_nvcc()] + NVCC_FLAGS
           + ['-o', tmp, os.path.join(CSRC, name + '.cu')] + NVCC_LIBS)
    tracing.count('kernels.nvcc')
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError('nvcc failed for %s.cu:\n%s\n%s'
                           % (name, proc.stdout, proc.stderr))
    if proc.stderr.strip():
        sys.stderr.write('nvcc %s.cu:\n%s\n' % (name, proc.stderr))
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with tracing.span('kernels.load'):
                lib = ctypes.CDLL(build(name))
                for fn, argtypes in SIGNATURES[name].items():
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError('%s: CUDA error %d at launch' % (what, rc))


def dtype_code(dtype) -> int:
    """The kernels' element type switch: 0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError('CUDA kernels take float32 or bfloat16, got %s'
                        % dtype)
    return codes[dtype]


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# every kernel wrapper, by name: its counters are ``launches`` and
# ``captures`` (``counted``)
COUNTED = {}


def counted(fn):
    """Register a kernel wrapper and give it its two counters: ``launches``
    (eager launches) and ``captures`` (calls that a CUDA graph recorded)."""
    fn.launches = 0
    fn.captures = 0
    COUNTED[fn.__name__] = fn
    return fn


def count_launch(fn) -> None:
    """Add one to ``fn.launches`` for a launch of its kernel, or to
    ``fn.captures`` for a call that a CUDA graph captures: that call
    records the launch, and the graph's replays run the kernel without the
    wrapper (a graph decode counts its replays, ``engine.graphs``)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captures += 1
    else:
        fn.launches += 1


def check_aligned(what: str, nbytes: int, *tensors) -> None:
    """The kernel loads ``nbytes`` at a time: every tensor must start on an
    ``nbytes`` boundary (a view at an odd offset may not)."""
    for x in tensors:
        if x.data_ptr() % nbytes:
            raise ValueError('%s: a tensor starts off a %d-byte boundary'
                             % (what, nbytes))
