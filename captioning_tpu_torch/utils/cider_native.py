"""ctypes binding for the native C++ CIDEr-D scorer (native/cider_d.cpp).

The port's copy of ``captioning_tpu/utils/cider_native.py``; it builds the
shared ``native/cider_d.cpp`` as ``data/native_io.py`` builds
``native/dataio.cpp``.

Drop-in fast path for the SCST reward loop: operates on int32 token
matrices directly (no string serialization).  Falls back to the Python
scorer when the shared library is missing; ``build_native()`` compiles it
with make.  Exact-match semantics are covered by tests/test_cider_native.py
(the original) and tests/test_torch_port_copies.py (this copy).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), '..', '..', 'native')
_LIB_PATH = os.path.join(_NATIVE_DIR, 'libciderd.so')

_lib = None


def build_native() -> bool:
    try:
        subprocess.run(['make', '-C', _NATIVE_DIR, 'libciderd.so'],
                       check=True, capture_output=True)
        return True
    except Exception as e:  # toolchain missing etc.
        print('cider native build failed:', e)
        return False


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_NATIVE_DIR, 'cider_d.cpp')
    stale = (os.path.isfile(src) and os.path.isfile(_LIB_PATH)
             and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH))
    if not os.path.isfile(_LIB_PATH) or stale:
        # never load a .so older than its source (make's dependency check
        # is cheap and idempotent)
        if not build_native() and not os.path.isfile(_LIB_PATH):
            return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.ciderd_new.restype = ctypes.c_void_p
    lib.ciderd_new.argtypes = [ctypes.c_double]
    lib.ciderd_free.argtypes = [ctypes.c_void_p]
    lib.ciderd_load_df.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags='C'),
        np.ctypeslib.ndpointer(np.int32, flags='C'),
        np.ctypeslib.ndpointer(np.float64, flags='C'),
        ctypes.c_int64]
    lib.ciderd_score.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags='C'), ctypes.c_int64,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags='C'), ctypes.c_int64,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags='C'), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags='C'),
        np.ctypeslib.ndpointer(np.float64, flags='C')]
    _lib = lib
    return lib


class NativeCiderD:
    """Token-matrix CIDEr-D over the prepro_ngrams -idxs df cache."""

    def __init__(self, df_pkl_or_dict, ref_len: Optional[float] = None):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError('native cider library unavailable')
        self._lib = lib

        if isinstance(df_pkl_or_dict, str):
            import pickle
            path = (df_pkl_or_dict if df_pkl_or_dict.endswith(('.p', '.pkl'))
                    else 'data/%s.p' % df_pkl_or_dict)
            with open(path, 'rb') as f:
                pkl = pickle.load(f, encoding='latin-1')
            df = pkl['document_frequency']
            ref_len = float(pkl['ref_len'])
        else:
            df = df_pkl_or_dict
            assert ref_len is not None

        self._handle = lib.ciderd_new(ctypes.c_double(ref_len))
        # flatten ngram-token keys (tuples of str ids) into int arrays
        toks, lens, dfs = [], [], []
        for ngram, d in df.items():
            ids = [int(t) for t in ngram]
            toks.extend(ids)
            lens.append(len(ids))
            dfs.append(float(d))
        toks = np.asarray(toks, np.int32)
        lens = np.asarray(lens, np.int32)
        dfs = np.asarray(dfs, np.float64)
        lib.ciderd_load_df(self._handle, np.ascontiguousarray(toks),
                           np.ascontiguousarray(lens),
                           np.ascontiguousarray(dfs), len(lens))

    def __del__(self):
        if getattr(self, '_handle', None) and _lib is not None:
            _lib.ciderd_free(self._handle)
            self._handle = None

    def score(self, cands: np.ndarray, refs: np.ndarray,
              ref_group_offsets: np.ndarray,
              cand_group: np.ndarray) -> np.ndarray:
        """cands [N, L] int32; refs [R, Lr] int32; ref_group_offsets
        [G+1] int64; cand_group [N] int32 -> scores [N] float64."""
        cands = np.ascontiguousarray(cands, np.int32)
        refs = np.ascontiguousarray(refs, np.int32)
        offs = np.ascontiguousarray(ref_group_offsets, np.int64)
        grp = np.ascontiguousarray(cand_group, np.int32)
        out = np.zeros(cands.shape[0], np.float64)
        self._lib.ciderd_score(
            self._handle, cands, cands.shape[0], cands.shape[1],
            refs, refs.shape[0], refs.shape[1],
            offs, len(offs) - 1, grp, out)
        return out


def native_get_scores(scorer: NativeCiderD, data_gts, gen_result,
                      cider_weight: float = 1.0):
    """get_scores (reference rewards.py:83-114) on the native scorer."""
    gen_result = np.asarray(gen_result)
    B = len(data_gts)
    N = gen_result.shape[0]
    n = N // B

    ref_rows = []
    offsets = [0]
    for g in data_gts:
        for row in g:
            ref_rows.append(np.asarray(row, np.int32))
        offsets.append(offsets[-1] + len(g))
    maxw = max(r.shape[0] for r in ref_rows)
    refs = np.zeros((len(ref_rows), maxw), np.int32)
    for i, r in enumerate(ref_rows):
        refs[i, :r.shape[0]] = r

    groups = np.repeat(np.arange(B, dtype=np.int32), n)
    scores = scorer.score(np.ascontiguousarray(gen_result, np.int32), refs,
                          np.asarray(offsets, np.int64), groups)
    return (scores * cider_weight).astype(np.float32)


def native_self_critical_reward(scorer: NativeCiderD, greedy_res, data_gts,
                                gen_result, cider_weight: float = 1.0):
    """get_self_critical_reward (reference rewards.py:41-81) on the native
    scorer: one call scores samples + greedy baselines."""
    greedy_res = np.asarray(greedy_res)
    gen_result = np.asarray(gen_result)
    B = len(data_gts)
    N = gen_result.shape[0]
    n = N // B

    ref_rows = []
    offsets = [0]
    for g in data_gts:
        for row in g:
            ref_rows.append(np.asarray(row, np.int32))
        offsets.append(offsets[-1] + len(g))
    maxw = max(r.shape[0] for r in ref_rows)
    refs = np.zeros((len(ref_rows), maxw), np.int32)
    for i, r in enumerate(ref_rows):
        refs[i, :r.shape[0]] = r

    L = max(gen_result.shape[1], greedy_res.shape[1])
    cands = np.zeros((N + B, L), np.int32)
    cands[:N, :gen_result.shape[1]] = gen_result
    cands[N:, :greedy_res.shape[1]] = greedy_res
    groups = np.concatenate([np.repeat(np.arange(B, dtype=np.int32), n),
                             np.arange(B, dtype=np.int32)])
    scores = scorer.score(cands, refs, np.asarray(offsets, np.int64),
                          groups) * cider_weight
    adv = scores[:N].reshape(B, n) - scores[N:][:, None]
    adv = adv.reshape(N)
    return np.repeat(adv[:, None], gen_result.shape[1], 1).astype(np.float32)
