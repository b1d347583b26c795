"""Per-key feature store over 4 backends (dir of npy/npz, lmdb, h5, pth).

TPU-native counterpart of the reference HybridLoader
(``captioning/data/dataloader.py:21-83``).  Backend chosen
by path suffix; optional ``in_memory`` caches the *compressed* bytes.  The
``.pth`` backend loads a torch key->tensor dict (torch is host-side only
here); lmdb is gated on the ``lmdb`` package being importable.
"""

from __future__ import annotations

import io
import os
import threading
from typing import Any, Dict

import numpy as np


def _load_npy(raw: bytes) -> np.ndarray:
    return np.load(io.BytesIO(raw))


def _load_npz(raw: bytes) -> np.ndarray:
    x = np.load(io.BytesIO(raw))
    # normally 'feat'; cocotest_bu mistakenly uses 'z' (reference :38-41)
    return x['feat'] if 'feat' in x else x['z']


class HybridLoader:
    def __init__(self, db_path: str, ext: str, in_memory: bool = False):
        self.db_path = db_path
        self.ext = ext
        self.loader = _load_npy if ext == '.npy' else _load_npz

        if db_path.endswith('.lmdb'):
            self.db_type = 'lmdb'
            import lmdb  # optional dep; gated
            self._env = lmdb.open(
                db_path, readonly=True, lock=False, readahead=False,
                max_readers=512, subdir=os.path.isdir(db_path))
        elif db_path.endswith('.pth'):
            self.db_type = 'pth'
            import torch
            self.feat_file = torch.load(db_path, map_location='cpu')
            self.loader = lambda x: np.asarray(x)
            print('HybridLoader: ext is ignored')
        elif db_path.endswith('h5'):
            self.db_type = 'h5'
            self.loader = lambda x: np.array(x).astype('float32')
            self._h5_local = threading.local()
        else:
            self.db_type = 'dir'

        self.in_memory = in_memory
        self.features: Dict[str, Any] = {}
        self._cache_lock = threading.Lock()

    def _h5_file(self):
        # h5py handles are not thread-safe; keep one per reader thread.
        import h5py
        f = getattr(self._h5_local, 'f', None)
        if f is None:
            f = h5py.File(self.db_path, 'r')
            self._h5_local.f = f
        return f

    def get(self, key: str) -> np.ndarray:
        if self.in_memory:
            with self._cache_lock:
                cached = self.features.get(key)
            if cached is not None:
                # decode OUTSIDE the lock: the npy/npz parse + inflate is
                # the dominant per-item cost, and serializing it through
                # the cache lock would single-thread the whole pipeline
                return self.loader(cached)

        if self.db_type == 'lmdb':
            with self._env.begin(write=False) as txn:
                f_input = txn.get(key.encode('ascii'))
            if f_input is None:
                raise KeyError(key)
        elif self.db_type == 'pth':
            f_input = self.feat_file[key]
        elif self.db_type == 'h5':
            f_input = self._h5_file()[key]
        else:
            with open(os.path.join(self.db_path, key + self.ext), 'rb') as f:
                f_input = f.read()

        if self.in_memory and self.db_type in ('lmdb', 'dir'):
            with self._cache_lock:
                self.features.setdefault(key, f_input)

        return self.loader(f_input)
