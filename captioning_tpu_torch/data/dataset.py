"""COCO-talk dataset + async host input pipeline for TPU.

Behavioural port of ``captioning/data/dataloader.py:85-424``
redesigned for an XLA world:

* Batches come out with **static shapes**: attention features are padded to
  a *bucket* length (smallest configured bucket >= the batch max, else the
  batch max rounded up to a multiple of 8) instead of the exact per-batch
  max, so jit recompiles only once per bucket.
* ``att_masks`` is always returned (all-ones when uniform) — masked
  attention with an all-ones mask is mathematically the reference's
  mask-free path, and a present mask keeps jit signatures stable.
* The torch multi-worker loader + private-field prefetch compensation
  (reference dataloader.py:355-368) is replaced by a thread-pool pipeline
  that snapshots the resumable sampler state *into each batch*, so
  ``DataLoader.state_dict()`` is exact by construction.

Collation semantics preserved exactly: seq_per_img caption sampling with
replacement (``get_captions``, reference :163-180), labels shaped
[B, seq_per_img, L+2] with bos/eos zeros, masks counting tokens+2, raw
``gts`` arrays for reward computation, restval->train split logic, box
feature normalization + area sort, fc fallback to att mean.
"""

from __future__ import annotations

import json
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import numpy.random as npr

from .hybrid_loader import HybridLoader


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Dataset:
    def get_vocab_size(self):
        return self.vocab_size

    def get_vocab(self):
        return self.ix_to_word

    def get_seq_length(self):
        return self.seq_length

    def __init__(self, opt):
        self.opt = opt
        self.seq_per_img = opt.seq_per_img
        self.rng_seed = int(getattr(opt, 'data_rng_seed', 123) or 123)

        self.use_fc = getattr(opt, 'use_fc', True)
        self.use_att = getattr(opt, 'use_att', True)
        self.use_box = getattr(opt, 'use_box', 0)
        self.norm_att_feat = getattr(opt, 'norm_att_feat', 0)
        self.norm_box_feat = getattr(opt, 'norm_box_feat', 0)

        print('DataLoader loading json file: ', opt.input_json)
        self.info = json.load(open(opt.input_json))
        if 'ix_to_word' in self.info:
            self.ix_to_word = self.info['ix_to_word']
            self.vocab_size = len(self.ix_to_word)
            print('vocab size is ', self.vocab_size)

        print('DataLoader loading h5 file: ', opt.input_fc_dir,
              opt.input_att_dir, opt.input_box_dir, opt.input_label_h5)
        if opt.input_label_h5 != 'none':
            import h5py
            with h5py.File(opt.input_label_h5, 'r') as h5_label_file:
                seq_size = h5_label_file['labels'].shape
                self.label = h5_label_file['labels'][:]
                self.seq_length = seq_size[1]
                print('max sequence length in data is', self.seq_length)
                self.label_start_ix = h5_label_file['label_start_ix'][:]
                self.label_end_ix = h5_label_file['label_end_ix'][:]
            self.has_labels = True
        else:
            self.seq_length = 1
            self.has_labels = False

        self.data_in_memory = getattr(opt, 'data_in_memory', False)
        self.fc_loader = HybridLoader(opt.input_fc_dir, '.npy', in_memory=self.data_in_memory)
        self.att_loader = HybridLoader(opt.input_att_dir, '.npz', in_memory=self.data_in_memory)
        self.box_loader = HybridLoader(opt.input_box_dir, '.npy', in_memory=self.data_in_memory)

        self.num_images = len(self.info['images'])
        print('read %d image features' % self.num_images)

        # native fused batch IO (native/dataio.cpp): one GIL-free C++ call
        # decodes a whole batch of npy/npz straight into the padded att
        # buffer.  Eligible only when the batch is a pure load — att from a
        # plain directory, fc from a directory or absent, and none of the
        # per-item transforms (box concat, L2 norm) the Python path applies.
        # Any native failure at runtime falls back permanently (collate_native
        # raises; _SplitPipeline clears the handle).
        self.native_io = None
        if (int(getattr(opt, 'native_io', 1) or 0)
                and self.use_att and not self.use_box
                and not self.norm_att_feat and not self.data_in_memory
                and self.att_loader.db_type == 'dir'
                and (not self.use_fc or self.fc_loader.db_type == 'dir')):
            from . import native_io as _nio
            if _nio.available():
                self.native_io = _nio.NativeBatchLoader(
                    int(getattr(opt, 'att_feat_size', 2048)),
                    int(getattr(opt, 'fc_feat_size', 2048)),
                    int(getattr(opt, 'num_data_threads', 4) or 4))

        # split assignment incl. restval (reference :143-157)
        self.split_ix = {'train': [], 'val': [], 'test': []}
        for ix in range(len(self.info['images'])):
            img = self.info['images'][ix]
            if 'split' not in img:
                self.split_ix['train'].append(ix)
                self.split_ix['val'].append(ix)
                self.split_ix['test'].append(ix)
            elif img['split'] == 'train':
                self.split_ix['train'].append(ix)
            elif img['split'] == 'val':
                self.split_ix['val'].append(ix)
            elif img['split'] == 'test':
                self.split_ix['test'].append(ix)
            elif opt.train_only == 0:  # restval
                self.split_ix['train'].append(ix)

        print('assigned %d images to split train' % len(self.split_ix['train']))
        print('assigned %d images to split val' % len(self.split_ix['val']))
        print('assigned %d images to split test' % len(self.split_ix['test']))

        # static-shape buckets for att length
        sizes = getattr(opt, 'att_bucket_sizes', '') or ''
        if isinstance(sizes, str):
            self.att_buckets = sorted(int(s) for s in sizes.split(',') if s.strip())
        else:
            self.att_buckets = sorted(int(s) for s in sizes)

    def get_captions(self, ix, seq_per_img, it_pos_now=0):
        """Sample seq_per_img captions (reference :163-180).

        Unlike the reference (global ``random`` module state, dataloader.py:
        168-176), draws come from a private per-item Random keyed on
        (loader seed, image index, iteration position): item loading is
        deterministic under thread-pool scheduling, reproducible across
        resume, and isolated from any other use of the global RNG.
        """
        ix1 = self.label_start_ix[ix] - 1  # label_start_ix is 1-indexed
        ix2 = self.label_end_ix[ix] - 1
        ncap = ix2 - ix1 + 1
        assert ncap > 0, 'an image does not have any label.'
        # mix (seed, ix, position) into one int (random.Random on py3.12
        # accepts only scalar seeds)
        mixed = (self.rng_seed * 1000003 + int(ix)) * 1000003 + int(it_pos_now)
        rng = random.Random(mixed)

        if ncap < seq_per_img:
            seq = np.zeros([seq_per_img, self.seq_length], dtype='int')
            for q in range(seq_per_img):
                ixl = rng.randint(ix1, ix2)
                seq[q, :] = self.label[ixl, :self.seq_length]
        else:
            ixl = rng.randint(ix1, ix2 - seq_per_img + 1)
            seq = self.label[ixl: ixl + seq_per_img, :self.seq_length]
        return seq

    def _bucket_len(self, max_len: int) -> int:
        for b in self.att_buckets:
            if b >= max_len:
                return b
        return _round_up(max(max_len, 1), 8)

    def get_item(self, index):
        """Load one sample (reference __getitem__ :262-299)."""
        ix, it_pos_now, wrapped = index
        if self.use_att:
            att_feat = self.att_loader.get(str(self.info['images'][ix]['id']))
            att_feat = att_feat.reshape(-1, att_feat.shape[-1])
            if self.norm_att_feat:
                att_feat = att_feat / np.linalg.norm(att_feat, 2, 1, keepdims=True)
            if self.use_box:
                box_feat = self.box_loader.get(str(self.info['images'][ix]['id']))
                x1, y1, x2, y2 = np.hsplit(box_feat, 4)
                h, w = self.info['images'][ix]['height'], self.info['images'][ix]['width']
                box_feat = np.hstack((x1 / w, y1 / h, x2 / w, y2 / h,
                                      (x2 - x1) * (y2 - y1) / (w * h)))
                if self.norm_box_feat:
                    box_feat = box_feat / np.linalg.norm(box_feat, 2, 1, keepdims=True)
                att_feat = np.hstack([att_feat, box_feat])
                att_feat = np.stack(sorted(att_feat, key=lambda x: x[-1], reverse=True))
        else:
            att_feat = np.zeros((0, 0), dtype='float32')
        if self.use_fc:
            try:
                fc_feat = self.fc_loader.get(str(self.info['images'][ix]['id']))
            except Exception:
                # average of attention when no fc provided (bottom-up feats)
                fc_feat = att_feat.mean(0)
        else:
            fc_feat = np.zeros((0,), dtype='float32')
        seq = (self.get_captions(ix, self.seq_per_img, it_pos_now)
               if self.has_labels else None)
        return (fc_feat, att_feat, seq, ix, it_pos_now, wrapped)

    def _assemble_bookkeeping(self, items: List[Any], split: str
                              ) -> Dict[str, Any]:
        """Label/mask/gts/infos/bounds assembly shared by ``collate``
        (reference collate_func :204-260) and ``collate_native`` — one
        implementation so the two batch paths cannot drift apart.

        ``items``: list of (ix, it_pos_now, wrapped, seq[seq_per_img, L]).
        """
        seq_per_img = self.seq_per_img
        label_batch, gts, infos = [], [], []
        wrapped = False
        it_pos_now = 0
        for ix, it_pos_now, tmp_wrapped, tmp_seq in items:
            if tmp_wrapped:
                wrapped = True
            tmp_label = np.zeros([seq_per_img, self.seq_length + 2],
                                 dtype='int')
            if self.has_labels:
                tmp_label[:, 1:self.seq_length + 1] = tmp_seq
                gts.append(self.label[self.label_start_ix[ix] - 1:
                                      self.label_end_ix[ix]])
            else:
                gts.append([])
            label_batch.append(tmp_label)
            infos.append({
                'ix': ix,
                'id': self.info['images'][ix]['id'],
                'file_path': self.info['images'][ix].get('file_path', ''),
            })
        labels = np.vstack(label_batch)
        nonzeros = (labels != 0).sum(1) + 2
        masks = (np.arange(self.seq_length + 2)[None, :]
                 < nonzeros[:, None]).astype('float32')
        n = len(items)
        return {'labels': labels.reshape(n, seq_per_img, -1),
                'masks': masks.reshape(n, seq_per_img, -1),
                'gts': gts,
                'bounds': {'it_pos_now': it_pos_now,
                           'it_max': len(self.split_ix[split]),
                           'wrapped': wrapped},
                'infos': infos}

    def collate(self, batch: List[Any], split: str) -> Dict[str, Any]:
        """Assemble a static-shape batch (reference collate_func :182-260)."""
        fc_batch = [s[0] for s in batch]
        att_batch = [s[1] for s in batch]

        data: Dict[str, Any] = self._assemble_bookkeeping(
            [(ix, pos, wr, seq) for _, _, seq, ix, pos, wr in batch], split)
        data['fc_feats'] = np.stack(fc_batch).astype('float32')

        max_att_len = max(_.shape[0] for _ in att_batch)
        pad_len = self._bucket_len(max_att_len) if self.use_att else max(max_att_len, 1)
        feat_dim = att_batch[0].shape[1] if att_batch[0].ndim == 2 and att_batch[0].shape[1] else 1
        data['att_feats'] = np.zeros([len(att_batch), pad_len, feat_dim], dtype='float32')
        data['att_masks'] = np.zeros([len(att_batch), pad_len], dtype='float32')
        for i, att in enumerate(att_batch):
            if att.size:
                data['att_feats'][i, :att.shape[0]] = att
            data['att_masks'][i, :att.shape[0]] = 1
        return data

    def collate_native(self, indices: List[Any], split: str) -> Dict[str, Any]:
        """Native-IO batch assembly: same output, byte for byte, as
        ``pool.map(get_item) + collate`` (tests/test_native_io.py), with the
        feature reads fused into two libdataio calls (header scan to size the
        bucket, then decode into the padded slots)."""
        seq_per_img = self.seq_per_img
        nio = self.native_io
        ids = [str(self.info['images'][ix]['id']) for ix, _, _ in indices]
        att_paths = [os.path.join(self.att_loader.db_path, i + self.att_loader.ext)
                     for i in ids]
        rows = nio.scan_rows(att_paths)
        pad_len = self._bucket_len(int(rows.max()))
        fc_paths = None
        if self.use_fc:
            fc_paths = [os.path.join(self.fc_loader.db_path, i + '.npy')
                        for i in ids]
        att, fc, fc_ok = nio.load(att_paths, pad_len, fc_paths, rows)

        data: Dict[str, Any] = {}
        data['att_feats'] = att
        data['att_masks'] = (np.arange(pad_len)[None, :]
                             < rows[:, None]).astype('float32')
        if self.use_fc:
            for i in np.nonzero(~fc_ok)[0]:
                # fc absent: att-mean fallback over the same f32 values the
                # Python path means over (dataset.py get_item :178-183)
                fc[i] = att[i, :rows[i]].mean(0)
            data['fc_feats'] = fc
        else:
            data['fc_feats'] = np.zeros((len(indices), 0), dtype='float32')

        data.update(self._assemble_bookkeeping(
            [(ix, pos, wr,
              self.get_captions(ix, seq_per_img, pos)
              if self.has_labels else None)
             for ix, pos, wr in indices], split))
        return data

    def __len__(self):
        return len(self.info['images'])


class MySampler:
    """Resumable index sampler (reference dataloader.py:371-423).

    Shuffle permutations come from a private RandomState (seeded per
    sampler), never the global numpy RNG: the producer thread draws
    concurrently with user code, and tests must not depend on execution
    order. The RNG state rides along in state_dict so epoch boundaries
    after a resume replay the same permutations as an uninterrupted run.
    """

    def __init__(self, index_list, shuffle, wrap, seed=123):
        self.index_list = index_list
        self.shuffle = shuffle
        self.wrap = wrap
        self._rng = npr.RandomState(seed)
        self._reset_iter()

    def next(self):
        wrapped = False
        if self.iter_counter == len(self._index_list):
            self._reset_iter()
            if self.wrap:
                wrapped = True
            else:
                raise StopIteration()
        if len(self._index_list) == 0:
            return None
        elem = (self._index_list[self.iter_counter], self.iter_counter + 1, wrapped)
        self.iter_counter += 1
        return elem

    def _reset_iter(self):
        if self.shuffle:
            rand_perm = self._rng.permutation(len(self.index_list))
            self._index_list = [self.index_list[_] for _ in rand_perm]
        else:
            self._index_list = self.index_list
        self.iter_counter = 0

    def __len__(self):
        return len(self.index_list)

    def load_state_dict(self, state_dict=None):
        if state_dict is None:
            return
        self._index_list = state_dict['index_list']
        self.iter_counter = state_dict['iter_counter']
        if state_dict.get('rng_state') is not None:
            self._rng.set_state(state_dict['rng_state'])

    def state_dict(self):
        return {'index_list': list(self._index_list),
                'iter_counter': self.iter_counter,
                'rng_state': self._rng.get_state()}


class _SplitPipeline:
    """Background batch producer for one split.

    A single producer thread draws indices from the sampler (keeping order),
    fans item loading across a shared thread pool, collates, snapshots the
    sampler state into the batch, and enqueues.  Exactness of resume comes
    from consuming ``_sampler_state`` of the *last consumed* batch.
    """

    def __init__(self, dataset: Dataset, sampler: MySampler, split: str,
                 batch_size: int, pool: ThreadPoolExecutor, depth: int = 4):
        if sampler.wrap and len(sampler) == 0:
            raise ValueError('split %r has no images' % split)
        self.dataset = dataset
        self.sampler = sampler
        self.split = split
        self.batch_size = batch_size
        self.pool = pool
        self.depth = depth
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._epoch_end = object()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # sampler state BEFORE the producer draws anything: the resume value
        # until a batch is consumed (the producer prefetches concurrently,
        # so reading sampler.state_dict() after _start_thread would capture
        # a mid-epoch position and a resumed run would skip images)
        self.initial_state = sampler.state_dict()
        self._start_thread()

    def _start_thread(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._produce_guarded,
                                        daemon=True)
        self._thread.start()

    def _produce_guarded(self):
        # a producer that dies silently deadlocks every get_batch() caller;
        # stash the exception and wake the consumer so it re-raises there
        try:
            self._produce()
        except BaseException as e:  # noqa: BLE001 — relay to consumer
            self._error = e
            while not self._stop.is_set():
                try:
                    self._queue.put(self._epoch_end, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def _produce(self):
        while not self._stop.is_set():
            indices = []
            hit_end = False
            for _ in range(self.batch_size):
                try:
                    indices.append(self.sampler.next())
                except StopIteration:
                    hit_end = True
                    break
            if indices:
                batch = None
                if self.dataset.native_io is not None:
                    try:
                        batch = self.dataset.collate_native(indices, self.split)
                    except Exception as e:  # noqa: BLE001 — any decode failure
                        print('native IO failed (%s); falling back to the '
                              'Python item path' % e)
                        self.dataset.native_io = None
                if batch is None:
                    items = list(self.pool.map(self.dataset.get_item, indices))
                    batch = self.dataset.collate(items, self.split)
                batch['_sampler_state'] = self.sampler.state_dict()
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            if hit_end:
                while not self._stop.is_set():
                    try:
                        self._queue.put(self._epoch_end, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if not self.sampler.wrap:
                    return  # thread restarts on reset

    def get_batch(self):
        while True:
            if self._error is not None:
                raise RuntimeError('data producer thread failed for split %r'
                                   % self.split) from self._error
            item = self._queue.get()
            if item is self._epoch_end:
                if self._error is not None:
                    raise RuntimeError(
                        'data producer thread failed for split %r'
                        % self.split) from self._error
                if not self.sampler.wrap:
                    # the non-wrap producer ALWAYS returns right after its
                    # epoch_end put, so restart deterministically (an
                    # is_alive() check can observe the thread between the
                    # put and its return and hang this consumer forever)
                    if len(self.sampler) == 0:
                        raise ValueError('split %r has no images'
                                         % self.split)
                    self._thread.join()
                    self._start_thread()
                continue
            return item

    def reset(self, sampler_state=None):
        self._stop.set()
        if self._thread is not None:
            # wait until the producer actually exits — a timed-out join
            # would leave a zombie producer racing the new thread on the
            # same sampler and enqueueing stale pre-reset batches.  Drain
            # while waiting so a producer blocked in put() sees _stop.
            while self._thread.is_alive():
                self._thread.join(timeout=0.5)
                try:
                    while True:
                        self._queue.get_nowait()
                except queue.Empty:
                    pass
        # drain queue
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if sampler_state is not None:
            self.sampler.load_state_dict(sampler_state)
        else:
            self.sampler._reset_iter()
        self._error = None
        self.initial_state = self.sampler.state_dict()
        self._start_thread()


class DataLoader:
    """Split-keyed loader facade (reference dataloader.py:304-368)."""

    def __init__(self, opt):
        self.opt = opt
        self.batch_size = opt.batch_size
        self.dataset = Dataset(opt)
        n_threads = int(getattr(opt, 'num_data_threads', 4) or 4)
        depth = int(getattr(opt, 'num_prefetch', 4) or 4)
        self._pool = ThreadPoolExecutor(max_workers=n_threads)

        self.pipelines: Dict[str, _SplitPipeline] = {}
        self._last_state: Dict[str, Dict] = {}
        seed = self.dataset.rng_seed
        for split in ['train', 'val', 'test']:
            sampler = MySampler(self.dataset.split_ix[split],
                                shuffle=(split == 'train'),
                                wrap=(split == 'train'),
                                seed=seed + len(split))
            self.pipelines[split] = _SplitPipeline(
                self.dataset, sampler, split, self.batch_size, self._pool, depth)
            self._last_state[split] = self.pipelines[split].initial_state

    def get_batch(self, split):
        batch = self.pipelines[split].get_batch()
        self._last_state[split] = batch.pop('_sampler_state')
        return batch

    def reset_iterator(self, split):
        self.pipelines[split].reset()
        self._last_state[split] = self.pipelines[split].initial_state

    def get_vocab_size(self):
        return self.dataset.get_vocab_size()

    @property
    def vocab_size(self):
        return self.get_vocab_size()

    def get_vocab(self):
        return self.dataset.get_vocab()

    def get_seq_length(self):
        return self.dataset.get_seq_length()

    @property
    def seq_length(self):
        return self.get_seq_length()

    def state_dict(self):
        return {split: dict(self._last_state[split]) for split in self.pipelines}

    def load_state_dict(self, state_dict=None):
        if state_dict is None:
            return
        for split in self.pipelines:
            if split in state_dict and state_dict[split] is not None:
                self.pipelines[split].reset(state_dict[split])
                self._last_state[split] = dict(state_dict[split])
