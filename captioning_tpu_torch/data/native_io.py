"""ctypes binding for the native batch feature loader (native/dataio.cpp).

Fast path for the training input pipeline: one GIL-free call decodes a whole
batch of .npy/.npz feature files straight into the padded ``att_feats``
buffer (fused read -> header parse -> inflate -> pad-slot write, internally
multithreaded).  The reference gets the equivalent from torch's C++
DataLoader workers (captioning/data/dataloader.py:304-368);
here the loader is a first-class native component so a single Python
producer thread stays off the interpreter lock.

Exact parity with the Python item path (HybridLoader.get + collate) is
covered by tests/test_native_io.py.  Falls back transparently when the
shared library or toolchain is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), '..', '..', 'native')
_LIB_PATH = os.path.join(_NATIVE_DIR, 'libdataio.so')

_lib = None
_lib_failed = False


def build_native() -> bool:
    try:
        subprocess.run(['make', '-C', _NATIVE_DIR, 'libdataio.so'],
                       check=True, capture_output=True)
        return True
    except Exception as e:  # toolchain missing etc.
        print('dataio native build failed:', e)
        return False


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    src = os.path.join(_NATIVE_DIR, 'dataio.cpp')
    stale = (os.path.isfile(src) and os.path.isfile(_LIB_PATH)
             and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH))
    if not os.path.isfile(_LIB_PATH) or stale:
        # never load a .so older than its source (make is cheap + idempotent)
        if not build_native() and not os.path.isfile(_LIB_PATH):
            _lib_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        print('dataio native load failed:', e)
        _lib_failed = True
        return None
    c_charpp = ctypes.POINTER(ctypes.c_char_p)
    lib.dataio_scan.restype = ctypes.c_int
    lib.dataio_scan.argtypes = [
        c_charpp, ctypes.c_int, ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.int64, flags='C'),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.dataio_load.restype = ctypes.c_int
    lib.dataio_load.argtypes = [
        c_charpp, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.float32, flags='C'),
        ctypes.c_void_p,  # expected_rows (int64*) or None
        c_charpp, ctypes.c_longlong,
        np.ctypeslib.ndpointer(np.float32, flags='C'),
        np.ctypeslib.ndpointer(np.int32, flags='C'),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load_lib() is not None


def _char_array(paths: Sequence[Optional[str]]):
    arr = (ctypes.c_char_p * len(paths))()
    for i, p in enumerate(paths):
        arr[i] = p.encode() if p else None
    return ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p))


class NativeBatchLoader:
    """Batch att(+fc) feature decode through libdataio (stateless — safe to
    share across the per-split producer threads).

    ``scan_rows(paths)`` -> per-file row counts (header-only decode);
    ``load(paths, pad_len, fc_paths, rows)`` -> (att [n, pad, D] f32
    zero-padded, fc [n, fc_dim] f32, fc_ok [n] bool), verifying each file's
    row count against the scan's ``rows`` so a dataset rewritten between
    the phases errors instead of producing an att/mask mismatch.  Raises
    RuntimeError on any decode error — callers fall back to the Python
    path.

    A scan-keeps-the-bytes single-read variant was measured SLOWER on a
    warm page cache (tools/bench_data.py, see native/dataio.cpp).
    """

    def __init__(self, feat_dim: int, fc_dim: int, nthreads: int = 4):
        self.feat_dim = int(feat_dim)
        self.fc_dim = int(fc_dim)
        self.nthreads = max(1, int(nthreads))
        self._lib = _load_lib()
        if self._lib is None:
            raise RuntimeError('libdataio unavailable')

    def scan_rows(self, paths: List[str]) -> np.ndarray:
        n = len(paths)
        rows = np.zeros(n, np.int64)
        err = ctypes.create_string_buffer(512)
        rc = self._lib.dataio_scan(_char_array(paths), n, self.feat_dim,
                                   rows, self.nthreads, err, len(err))
        if rc != 0:
            raise RuntimeError('dataio_scan: %s' % err.value.decode())
        return rows

    def load(self, paths: List[str], pad_len: int,
             fc_paths: Optional[List[Optional[str]]] = None,
             rows: Optional[np.ndarray] = None):
        n = len(paths)
        att = np.zeros((n, pad_len, self.feat_dim), np.float32)
        fc = np.zeros((n, max(self.fc_dim, 1)), np.float32)
        fc_ok = np.zeros(n, np.int32)
        err = ctypes.create_string_buffer(512)
        fcp = _char_array(fc_paths if fc_paths is not None else [None] * n)
        if rows is not None:
            rows = np.ascontiguousarray(rows, np.int64)
            rows_ptr = rows.ctypes.data_as(ctypes.c_void_p)
        else:
            rows_ptr = None
        rc = self._lib.dataio_load(
            _char_array(paths), n, self.feat_dim, pad_len, att, rows_ptr,
            fcp, self.fc_dim, fc, fc_ok, self.nthreads, err, len(err))
        if rc != 0:
            raise RuntimeError('dataio_load: %s' % err.value.decode())
        return att, fc, fc_ok.astype(bool)
