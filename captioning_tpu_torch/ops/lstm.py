"""The maxout-LSTM gate chain: sigmoid gates, maxout input transform, cell
update and output in one pass.

Replaces the TPU kernel ``captioning_tpu/ops/lstm.py:_kernel`` (wrapper
``maxout_lstm_gates_fused``).  For pre-activations ``s`` [N, 5H] (the
cell's ``i2h(x) + h2h(h)``, which stay GEMMs outside the kernel) and the
cell state ``c_prev`` [N, H]::

    i, f, o = sigmoid(s[:, :H]), sigmoid(s[:, H:2H]), sigmoid(s[:, 2H:3H])
    c = f * c_prev + i * max(s[:, 3H:4H], s[:, 4H:])
    h = o * tanh(c)

Every maxout cell of the port runs it: ``MaxoutLSTMCell`` (StackAtt /
DenseAtt three times a step, FC / NewFC / LM), the AdaAttMO core and the
Att2in2 / Att2all2 cores.  What bounds it on the H100: bytes (6 elements
read, 2 written per output element; 42 MB at N = 5120, H = 512, bf16).
``csrc/maxout_lstm.cu`` reads each input element once, coalesced, and
writes only h and c: a thread takes a 16-byte vector of each of the five
gate slices and of c_prev (8 bf16 or 4 float32 columns), on a grid sized
to the blocks the card holds at once; an H that is not a multiple of the
vector width, or a pointer off 16 bytes, takes one element a thread.

Rounding: the twin runs the JAX cell's chain op by op in the compute dtype
(in bf16 each sigmoid, the two products, their sum, tanh and the last
product round to bf16); the kernel computes in float32 and rounds at the
same points, without contracting a product and a sum into an FMA.  So the
two can differ only where the kernel's ``expf`` / ``tanhf`` differ from
those of ``torch.sigmoid`` / ``torch.tanh`` on the card, and in bf16 only
where such a float32 difference flips a rounding.  ``chip_smoke.py`` holds
them to atol 1e-6 in float32 and 2 bf16 ulps of the largest input in bf16;
on an H100 they came out bit-identical in both.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import recompute_grads


def maxout_lstm_gates_ref(s, c_prev):
    """Plain twin: the JAX ``maxout_lstm_gates_ref``, every op in the
    inputs' dtype.  Returns (next_h, next_c) [N, H]."""
    H = c_prev.shape[-1]
    gates = torch.sigmoid(s[:, :3 * H])
    in_transform = torch.maximum(s[:, 3 * H:4 * H], s[:, 4 * H:])
    next_c = gates[:, H:2 * H] * c_prev + gates[:, :H] * in_transform
    next_h = gates[:, 2 * H:] * torch.tanh(next_c)
    return next_h, next_c


def maxout_lstm_gates_fused(s, c_prev):
    """The gate chain of one maxout LSTM step.

    s: [N, 5H]; c_prev: [N, H]; both contiguous, of one dtype (float32 or
    bf16).  Returns (h, c) [N, H] in that dtype.  CPU tensors take the plain
    twin; CUDA tensors launch the kernel.

    Differentiable in s and c_prev (``MaxoutLSTMGates``): the backward
    recomputes ``maxout_lstm_gates_ref`` under autograd and launches no
    kernel, the JAX package's design for its kernels (no Pallas kernel
    there has a backward; its cells differentiate the plain chain), not a
    fallback: the forward on CUDA tensors is always the kernel."""
    if (s.dim() != 2 or c_prev.dim() != 2 or s.shape[0] != c_prev.shape[0]
            or s.shape[1] != 5 * c_prev.shape[1]):
        raise ValueError('maxout_lstm_gates_fused: s [N, 5H] and c_prev '
                         '[N, H], got %s and %s'
                         % (tuple(s.shape), tuple(c_prev.shape)))
    if not (s.is_contiguous() and c_prev.is_contiguous()):
        raise ValueError('maxout_lstm_gates_fused: s and c_prev must be '
                         'contiguous')
    if s.dtype != c_prev.dtype:
        raise ValueError('maxout_lstm_gates_fused: s is %s, c_prev %s'
                         % (s.dtype, c_prev.dtype))
    if torch.is_grad_enabled() and (s.requires_grad or c_prev.requires_grad):
        return MaxoutLSTMGates.apply(s, c_prev)
    return _forward(s, c_prev)


class MaxoutLSTMGates(torch.autograd.Function):
    """The kernel's forward with a backward by recompute through
    ``maxout_lstm_gates_ref``."""

    @staticmethod
    def forward(ctx, s, c_prev):
        ctx.save_for_backward(s, c_prev)
        return _forward(s, c_prev)

    @staticmethod
    def backward(ctx, grad_h, grad_c):
        return recompute_grads(maxout_lstm_gates_ref, ctx, (grad_h, grad_c))


def _forward(s, c_prev):
    if s.device.type == 'cpu':
        return maxout_lstm_gates_ref(s, c_prev)
    if not s.is_cuda or c_prev.device != s.device:
        raise ValueError('maxout_lstm_gates_fused: needs CUDA tensors on one '
                         'device')
    N, H = c_prev.shape
    lib = _build.load('maxout_lstm')
    h = torch.empty_like(c_prev)
    c = torch.empty_like(c_prev)
    rc = lib.maxout_lstm_gates(s.data_ptr(), c_prev.data_ptr(), h.data_ptr(),
                               c.data_ptr(), N, H, _build.dtype_code(s.dtype),
                               _build.stream_ptr(s.device))
    _build.check(rc, 'maxout_lstm_gates_fused')
    _build.count_launch(maxout_lstm_gates_fused)
    return h, c


_build.counted(maxout_lstm_gates_fused)
