"""A batch's host arrays to the device behind the host's other work.

``Stage(arrays, device)`` starts the copy of a batch's numpy arrays
({name: (array or None, torch dtype)}); ``wait()`` hands over the
tensors.  On a CUDA
device the arrays go through a ring of pinned host chunks (``CHUNK_BYTES``
each, made at first use and grown to the largest batch, once a process
and device), moved by a worker thread whose current stream is a copy
stream of its own.  The worker makes one ``torch._foreach_copy_`` call
whose pairs alternate a chunk's host copy (the array's piece into the
ring, on the intra-op threads) and that chunk's asynchronous copy to the
device, so the DMA of chunk i runs while chunk i + 1 is copied on the
host.  The call releases the interpreter lock for its whole length: the
caller's Python (a batch's strings) runs beside the copy, and the worker
takes the lock only to start and to end.  ``wait`` then orders the
caller's current stream after the copy stream's last event, without a
host sync.

The caller's thread allocates the destinations on its current stream and
makes the copy stream wait for that stream first, so the caching
allocator's stream order holds without ``record_stream``: a block freed by
earlier work is not written before that work has run, and the current
stream reads the tensors only after the copy's last event.  One stage at
a time uses a ring: the next waits for the last one's copies to end.

On any other device (the CPU) ``wait`` is ``torch.as_tensor(x,
dtype).to(device)`` on the caller's thread, and nothing is overlapped.
Either way the device holds the bytes that call gives.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# a chunk of the ring: a batch of 1000 x 36 x 2048 float32 features is
# ten of them
CHUNK_BYTES = 32 << 20
# a piece of the ring starts on a cache line, so it views as any dtype
ALIGN = 64


def pipelined(device: torch.device) -> bool:
    """Whether a copy to ``device`` goes through the ring and the worker."""
    return device.type == 'cuda'


class _Ring:
    """The pinned chunks, the copy stream and the worker thread of one
    device, and the last stage that used them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == 'cuda'
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.chunks = []
        self.last = None        # (future, done event) of the last stage
        self.worker = ThreadPoolExecutor(1, thread_name_prefix='h2d-stage',
                                         initializer=self._on_copy_stream)

    def _on_copy_stream(self):
        if self.cuda:
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self.stream)

    def _chunk(self, k: int) -> torch.Tensor:
        while len(self.chunks) <= k:
            self.chunks.append(torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                           pin_memory=self.cuda))
        return self.chunks[k]

    def copies(self, pairs):
        """(destinations, sources) of the worker's copies for each (host
        tensor, device tensor) of ``pairs``: the arrays packed into the
        ring's chunks in order, each piece copied into the ring and then
        from the ring to the device."""
        dsts, srcs, k, off = [], [], 0, 0
        for src, dst in pairs:
            src, dst = src.reshape(-1), dst.view(-1)
            size, n, a = dst.element_size(), dst.numel(), 0
            off = -(-off // ALIGN) * ALIGN
            while a < n:
                room = (CHUNK_BYTES - off) // size
                if room <= 0:
                    k, off = k + 1, 0
                    continue
                b = min(n, a + room)
                piece = self._chunk(k)[off:off + (b - a) * size].view(
                    dst.dtype)
                dsts += [piece, dst[a:b]]
                srcs += [src[a:b], piece]
                off += (b - a) * size
                a = b
        return dsts, srcs

    def settle(self):
        """Block until the last stage's worker has finished and its copies
        have ended, so that the chunks are free; raises nothing."""
        if self.last is not None:
            future, done = self.last
            future.exception()
            if done is not None:
                done.synchronize()

    def stage(self, dsts, srcs, done):
        """The worker's part: the copies in order, in one call; returns
        the time the last was enqueued.  ``done`` is recorded on the copy
        stream whatever happens, so a waiter can order itself after every
        copy that was issued."""
        try:
            if dsts:
                torch._foreach_copy_(dsts, srcs, non_blocking=self.cuda)
        finally:
            if done is not None:
                done.record(self.stream)
        return perf_counter()


_RINGS: Dict[Tuple[int, str], _Ring] = {}
_RINGS_LOCK = threading.Lock()


def _ring(device: torch.device) -> _Ring:
    """The ring of ``device`` in this process, made at its first use."""
    key = (os.getpid(), str(device))
    with _RINGS_LOCK:
        ring = _RINGS.get(key)
        if ring is None:
            ring = _RINGS[key] = _Ring(device)
    return ring


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


class Stage:
    """One batch's arrays on their way to the device.

    ``hidden`` (after ``wait``): the copy had ended when ``wait`` was
    reached.  ``nbytes``: the bytes the device receives.  ``start`` /
    ``end``: when the stage was submitted and when the worker enqueued its
    last copy (None where nothing ran on a worker)."""

    def __init__(self, arrays, device):
        self.device = _device(device)
        self.arrays = {k: None if x is None else (np.asarray(x), dtype)
                       for k, (x, dtype) in arrays.items()}
        self.start = perf_counter()
        self.end: Optional[float] = None
        self.hidden = False
        self.nbytes = 0
        self.out = None
        self.future = None
        self.done = None
        if not pipelined(self.device):
            return
        ring = _ring(self.device)
        self.out = {k: None if v is None else
                    torch.empty(v[0].shape, dtype=v[1], device=self.device)
                    for k, v in self.arrays.items()}
        ring.settle()
        pairs = [(torch.from_numpy(np.ascontiguousarray(v[0])), self.out[k])
                 for k, v in self.arrays.items() if v is not None]
        dsts, srcs = ring.copies(pairs)
        if ring.cuda:
            ring.stream.wait_stream(torch.cuda.current_stream(self.device))
            self.done = torch.cuda.Event()
        self.future = ring.worker.submit(ring.stage, dsts, srcs, self.done)
        ring.last = self.future, self.done

    def wait(self) -> Dict[str, Optional[torch.Tensor]]:
        """{name: the array on the device, or None}, ordered before the
        current stream's next work; raises what the worker raised."""
        if self.out is None:            # not pipelined: the copy now
            self.out = {k: None if v is None else
                        torch.as_tensor(v[0], dtype=v[1]).to(self.device)
                        for k, v in self.arrays.items()}
        elif self.future is not None:
            self.hidden = self.future.done() and (
                self.done is None or self.done.query())
            try:
                self.end = self.future.result()
            finally:
                self._order()
        self.nbytes = sum(x.nbytes for x in self.out.values()
                          if x is not None)
        return self.out

    def close(self):
        """Wait for a stage nobody will take (an error left it behind), so
        that no copy still writes into memory the device may reuse; raises
        nothing."""
        if self.future is None:
            return
        try:
            self.future.exception()
        finally:
            self._order()

    def _order(self):
        future, self.future = self.future, None
        if future is not None and self.done is not None:
            torch.cuda.current_stream(self.device).wait_event(self.done)
