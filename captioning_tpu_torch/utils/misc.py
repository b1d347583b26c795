"""Host-side helpers: pickles, sequence decode, ``model.npz`` trees and
the checkpoint writer.

The port's own copy of the part of ``captioning_tpu/utils/misc.py`` that it
uses (the JAX package's module also holds JAX runtime switches).  The
functions are the same, with ``save_pytree`` taking numpy trees, so a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np

bad_endings = ['with', 'in', 'on', 'of', 'a', 'at', 'to', 'for', 'an',
               'this', 'his', 'her', 'that', 'the']


def pickle_load(f):
    return pickle.load(f, encoding='latin-1')


def pickle_dump(obj, f):
    return pickle.dump(obj, f, protocol=2)


def decode_sequence(ix_to_word, seq):
    """Turn an [N, D] id array into strings (reference misc.py:62-84).

    Stops at the first 0 token; strips BPE '@@ ' joiners; honours the
    REMOVE_BAD_ENDINGS env toggle used by eval.
    """
    seq = np.asarray(seq)
    N, D = seq.shape
    out = []
    for i in range(N):
        txt = ''
        for j in range(D):
            ix = int(seq[i, j])
            if ix > 0:
                if j >= 1:
                    txt = txt + ' '
                txt = txt + ix_to_word[str(ix)]
            else:
                break
        if int(os.getenv('REMOVE_BAD_ENDINGS', '0')):
            flag = 0
            words = txt.split(' ')
            for j in range(len(words)):
                if words[-j - 1] not in bad_endings:
                    flag = -j
                    break
            txt = ' '.join(words[0:len(words) + flag])
        out.append(txt.replace('@@ ', ''))
    return out


def _flatten_tree(tree: Any, prefix: str = '') -> Dict[str, np.ndarray]:
    """Flatten a nested dict/list pytree of arrays into {path: array}."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten_tree(v, prefix + str(k) + '/'))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten_tree(v, prefix + '#%d/' % i))
    elif tree is None:
        flat[prefix + '@none'] = np.zeros((), dtype=np.int8)
    else:
        flat[prefix.rstrip('/')] = np.asarray(tree)
    return flat


def _unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split('/')
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if '@none' in node and len(node) == 1:
            return None
        keys = list(node.keys())
        if keys and all(k.startswith('#') for k in keys):
            items = sorted(((int(k[1:]), v) for k, v in node.items()))
            return [rebuild(v) for _, v in items]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """An npz tree as written, {path: array}: unlike ``load_pytree`` it
    keeps the '#<i>' list indices of an optimizer state whose lower chain
    slots are empty."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def load_pytree(path: str) -> Any:
    return _unflatten_tree(load_flat(path))


def save_pytree(tree: Any, path: str) -> None:
    np.savez(path, **_flatten_tree(tree))


def save_checkpoint(opt, params, infos, opt_state, histories=None, append=''):
    """Reference artifact contract (misc.py:87-102) with npz tensors."""
    if len(append) > 0:
        append = '-' + append
    if not os.path.isdir(opt.checkpoint_path):
        os.makedirs(opt.checkpoint_path)
    checkpoint_path = os.path.join(opt.checkpoint_path, 'model%s.npz' % append)
    save_pytree(params, checkpoint_path)
    print("model saved to {}".format(checkpoint_path))
    if opt_state is not None:
        optimizer_path = os.path.join(opt.checkpoint_path, 'optimizer%s.npz' % append)
        save_pytree(opt_state, optimizer_path)
    with open(os.path.join(opt.checkpoint_path, 'infos_' + opt.id + '%s.pkl' % append), 'wb') as f:
        pickle_dump(infos, f)
    if histories:
        with open(os.path.join(opt.checkpoint_path, 'histories_' + opt.id + '%s.pkl' % append), 'wb') as f:
            pickle_dump(histories, f)
