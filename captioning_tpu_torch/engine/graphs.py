"""CUDA-graph decodes: the counterpart of ``jax.jit`` over the JAX
package's eval decodes (``Captioner.sample_beam_jit`` /
``sample_stats_jit``, which compile the prepare, the bos step and the step
loop into one program with the early exit on the device).

A ``GraphDecode`` is one decode of a ``decoding.StepProgram`` at fixed
shapes and options.  It owns static input buffers (``fc``, ``att`` and
``att_masks`` are copied into them at each call), and holds the program's
setup captured as one graph and each step t as graph g_t, all in one
memory pool.  A call replays the setup, then g_0, g_1, ..., and reads the
exit flag after each, where the eager loop (``decoding.run_eager``) reads
it: one host read a step, as there.  The decode's shapes are fixed per
(B, beam, options), the model's caches are written in place and the
program's carry keeps its addresses, so each step is one fixed sequence
of kernels.  The transformer step's position ``t`` is a host int (B1's
argument and the row of its positional table): one graph per step, at
most ``seq_length`` of them, sharing the pool.

Before capture, one eager decode on the recorder's side stream builds
and loads the kernels' libraries and lets cuBLAS pick its algorithms
outside the capture.  A call returns clones of the outputs: the next
call's replays overwrite the carry, which a caller that defers its reads
by a batch (``eval_split``, the bench's pipelined loop) would otherwise
read as its own.  A capture that fails raises; nothing runs the eager
loop in its place.

Each kernel wrapper counts the calls a capture records
(``ops._build.count_launch``: ``captures``); a ``GraphDecode`` keeps which
kernels each of its graphs holds and how often it replayed each, so
``launches()`` gives the kernels its replays ran.

A ``GraphTrainStep`` is the counterpart of the JAX package's jitted train
steps (``Trainer.xe_step`` / ``sc_fused_step`` / ``sc_grad_step`` /
``struc_*``, one ``jax.jit`` program each): the forward, the backward, the
clip and the optimizer's update of one step, captured as one graph.  Its
inputs are copied into static buffers at each call; the scalars the step
reads (the learning rate in the optimizer's param group, the
scheduled-sampling probability) are 0-d tensors on the card that the
trainer fills before the replay, so one capture serves every value.  The
first call runs the step eagerly on the recorder's side stream (the
warm-up: the kernels' libraries load, cuBLAS picks its algorithms, the
optimizer makes its state), then captures it without running it.  The
generators the step draws from are registered with the graph
(``register_generator_state``): each replay draws from the generator's
current state and moves it on, as the eager step does, so a replay draws
what the eager step would.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from ..ops import _build
from .decoding import Carry, StepProgram, write_back


class CudaRecorder:
    """Records closures as ``torch.cuda.CUDAGraph``s in one memory pool,
    captured on one side stream (the one the warm-up runs on)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm(self, fn):
        """Run ``fn`` eagerly on the side stream, ordered after the work
        already queued and before what follows."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    # a capture records ``fn``'s kernels without running them
    runs_captures = False

    def capture(self, fn, generators=()):
        """A graph of ``fn``'s kernels; its ``replay()`` runs them on the
        current stream.  ``generators`` (CUDA ``torch.Generator``s that
        ``fn`` draws from, besides the default one) are registered with
        the graph, so each replay draws from their current states."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        # the cyclic collector waits until the capture ends: an earlier
        # graph held by a dead reference cycle, freed mid-capture, would
        # reset on the capturing stream and invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                fn()
        finally:
            if collecting:
                gc.enable()
        return graph


class EagerRecorder:
    """A recorder that captures a closure by running it once and replays
    it by running it again: the graph entries' plumbing (static buffers,
    the carry written back, fresh outputs, the caches) on any device.  For
    tests; no entry point chooses it."""

    # the capture runs ``fn``: a train step's capture is its first step
    runs_captures = True

    def __init__(self, device=None):
        """Takes a device as ``CudaRecorder`` does; runs on any."""

    def warm(self, fn):
        fn()

    def capture(self, fn, generators=()):
        fn()
        return SimpleNamespace(replay=fn)


def capture(recorder, fn, what, generators=()):
    """(``recorder.capture(fn, generators)``, {kernel wrapper name: the
    calls the capture recorded}); a capture that fails raises, naming
    ``what``."""
    before = {n: f.captures for n, f in _build.COUNTED.items()}
    try:
        graph = (recorder.capture(fn, generators) if generators
                 else recorder.capture(fn))
    except RuntimeError as e:
        raise RuntimeError('CUDA graph capture of %s failed: %s'
                           % (what, e)) from e
    return graph, {n: f.captures - before.get(n, 0)
                   for n, f in _build.COUNTED.items()
                   if f.captures > before.get(n, 0)}


def clone_tree(tree):
    """Every tensor of a tuple / dict tree cloned."""
    if isinstance(tree, tuple):
        return tuple(clone_tree(x) for x in tree)
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


class GraphDecode:
    """``prog`` captured at the shapes of ``fc``, ``att``, ``att_masks``
    (any of the last two may be None) by ``recorder``.  Calling it decodes
    new inputs of those shapes and returns ``prog.result``'s outputs,
    cloned."""

    def __init__(self, prog: StepProgram, fc, att, att_masks, recorder):
        self.prog = prog
        self.inputs = [None if x is None else x.clone()
                       for x in (fc, att, att_masks)]
        self.carry: Carry = None
        cuda = fc.is_cuda
        if cuda:
            # each capture empties the allocator's cache: so does the
            # baseline, so that the reserved difference is the pool's
            torch.cuda.synchronize(fc.device)
            torch.cuda.empty_cache()
            allocated = torch.cuda.memory_allocated(fc.device)
            reserved = torch.cuda.memory_reserved(fc.device)
        recorder.warm(self._warm)
        start = time.time()
        # graph 0 is the setup, graph t + 1 the body of step t
        self.captured: List[Dict[str, int]] = []
        self.graphs = [self._capture(recorder, self._setup, 'the setup')]
        for t in range(prog.steps):
            self.graphs.append(self._capture(
                recorder, lambda t=t: prog.body(self.carry, t),
                'step %d' % t))
        if cuda:
            torch.cuda.synchronize(fc.device)
        self.capture_s = time.time() - start
        self.replays = [0] * len(self.graphs)
        # what the entry holds on the card: its input buffers and the carry
        # (allocated), with the pool's free blocks (reserved)
        self.bytes_allocated = self.bytes_reserved = 0
        if cuda:
            torch.cuda.empty_cache()
            self.bytes_allocated = (torch.cuda.memory_allocated(fc.device)
                                    - allocated)
            self.bytes_reserved = (torch.cuda.memory_reserved(fc.device)
                                   - reserved)

    def _warm(self):
        carry = self.prog.setup(*self.inputs)
        for t in range(self.prog.steps):
            self.prog.body(carry, t)

    def _setup(self):
        carry = self.prog.setup(*self.inputs)
        if self.carry is None:
            self.carry = carry
        else:
            # a recorder that runs the closure again: into the first
            # carry's buffers, which the step graphs read
            write_back(self.carry, carry)

    def _capture(self, recorder, fn, what):
        graph, held = capture(recorder, fn, what)
        self.captured.append(held)
        return graph

    def __call__(self, fc, att, att_masks):
        for buf, x in zip(self.inputs, (fc, att, att_masks)):
            if buf is not None:
                buf.copy_(x)
        self._replay(0)
        steps = self.prog.steps
        for t in range(steps):
            self._replay(t + 1)
            if t + 1 < steps and not bool(self.carry['go']):
                break
        return clone_tree(self.prog.result(self.carry))

    def _replay(self, i):
        self.graphs[i].replay()
        self.replays[i] += 1

    def launches(self) -> Dict[str, int]:
        """Kernel wrapper name -> the launches this entry's replays ran
        (each graph's captured calls times its replays)."""
        return _weighted(self.captured, self.replays)

    def held(self) -> Dict[str, int]:
        """Kernel wrapper name -> the calls all of this entry's graphs
        captured."""
        return _weighted(self.captured, [1] * len(self.captured))


def _weighted(captured, times) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for held, n in zip(captured, times):
        for name, c in held.items():
            out[name] = out.get(name, 0) + c * n
    return out


class GraphTrainStep:
    """One train step, ``body(**inputs) -> {name: tensor}``, captured as
    one graph by ``recorder`` at the shapes of ``inputs`` (a dict of
    tensors or None).  ``generators``: the CUDA generators ``body`` draws
    from.  Making it runs the step once on ``inputs``: ``first`` holds that
    step's outputs.  Calling it with new inputs of those shapes runs the
    next step by one replay and returns the outputs, cloned.  The caller
    fills the step's scalar tensors before each call."""

    def __init__(self, body, inputs, generators, recorder):
        self.body = body
        self.inputs = {k: None if x is None else x.clone()
                       for k, x in inputs.items()}
        self.outputs = None
        cuda = any(x is not None and x.is_cuda for x in inputs.values())
        if not recorder.runs_captures:
            # the first step, eagerly: what loads and allocates lazily
            # does so here, outside the capture
            recorder.warm(self._run)
            first = clone_tree(self.outputs)
        if cuda:
            # the pool's size: what the card reserves across the capture,
            # against an emptied cache
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
        start = time.time()
        self.graph, self.captured = capture(recorder, self._run,
                                            'the train step',
                                            tuple(generators))
        if recorder.runs_captures:
            first = clone_tree(self.outputs)
        self.bytes_reserved = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            self.bytes_reserved = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.time() - start
        self.first = first
        self.replays = 0

    def _run(self):
        self.outputs = self.body(**self.inputs)

    def __call__(self, inputs):
        for name, x in inputs.items():
            buf = self.inputs[name]
            if buf is not None:
                buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        return clone_tree(self.outputs)

    def launches(self) -> Dict[str, int]:
        """Kernel wrapper name -> the launches this step's replays ran."""
        return _weighted([self.captured], [self.replays])

    def held(self) -> Dict[str, int]:
        """Kernel wrapper name -> the calls the graph captured."""
        return dict(self.captured)
