"""Microbench: the ancestry attend over a stacked cache, kernel against the
slice-then-attend twin: the port's counterpart of
``tools/bench_anc_attend.py``.

    python -m captioning_tpu_torch.tools.bench_anc_attend [N] [T] [iters] \\
        [--device cuda|cpu]

One beam step of self-attention at B = N / 5 images x beam 5, 6 layers,
8 heads, dk 64, bf16, over caches stacked ``[N, 6, h, T, dk]``, at
t = T - 2 (a nearly full cache): each layer's output is the next layer's
query, as the stacked-cache decode step ran its layers.  ``anc_attend``
reads layer l of the stack in place; the twin ``anc_attend_ref`` takes the
layer's slice first.  It checks one layer (l = 3) against the twin and
raises ``AssertionError`` beyond bf16 0.1 (the kernel keeps the scores in
float32 where the twin rounds them to bf16), then times the 6-layer step
both ways: CUDA events on the GPU (the default), the host clock with
``--device cpu``, where both time the twin.  Last, the t sweep: the
kernel's time on layer 3 at t 0 / 12 / 20 of T 21 and at t 47 of T 48
(``bench_beam_attend.SWEEP_T``), by CUDA-graph replay on the GPU (the host
clock on the CPU), which gives its fixed cost and per-step slope.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.anc_attend import anc_attend, anc_attend_ref
from .bench_beam_attend import SWEEP_T, sweep_timer, timer

L, H, DK, BW = 6, 8, 64, 5
ATOL = 0.1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('N', type=int, nargs='?', default=5120)
    p.add_argument('T', type=int, nargs='?', default=21)
    p.add_argument('iters', type=int, nargs='?', default=50)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    a = p.parse_args(argv)
    if a.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run the plain twin)')
    if a.N % BW or a.T < 2:
        raise ValueError('N must be a multiple of %d and T at least 2' % BW)
    device = torch.device(a.device)
    N, T = a.N, a.T
    t = T - 2
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g,
                           device=device).to(torch.bfloat16)
    K, V = rnd(N, L, H, T, DK), rnd(N, L, H, T, DK)
    q = rnd(N, H * DK)
    anc = torch.randint(0, BW, (N, T), generator=g, device=device,
                        dtype=torch.int32)

    err = (anc_attend(K, V, q, anc, 3, t, BW).float()
           - anc_attend_ref(K, V, q, anc, 3, t, BW).float()).abs().max()
    err = err.item()
    print('max_abs_err(single layer) = %.3e' % err)
    if not err <= ATOL:
        raise AssertionError('anc_attend vs twin: max err %g > %g'
                             % (err, ATOL))

    def step(fn):
        x = q
        for l in range(L):
            x = fn(K, V, x, anc, l, t, BW)
        return x

    run = timer(device, a.iters)
    times = {'kernel': run(lambda: step(anc_attend)),
             'twin': run(lambda: step(anc_attend_ref))}
    for name, ms in times.items():
        print('%-6s: %8.3f ms / 6-layer step (%7.1f us/layer)'
              % (name, ms, ms * 1000 / L))
    out = {'max_err': err, 'ms': times['kernel'] / L,
           'plain_ms': times['twin'] / L}
    del K, V
    run = sweep_timer(device, a.iters)
    out['sweep'] = {}
    for T_s, t_s in SWEEP_T:
        K, V = rnd(N, L, H, T_s, DK), rnd(N, L, H, T_s, DK)
        anc = torch.randint(0, BW, (N, T_s), generator=g, device=device,
                            dtype=torch.int32)
        out['sweep']['T %d t %d' % (T_s, t_s)] = run(
            lambda: anc_attend(K, V, q, anc, 3, t_s, BW))
        del K, V
    print('t sweep, kernel ms a layer (%s): %s'
          % ('CUDA-graph replay' if device.type == 'cuda'
             else 'host clock, CPU: the twin', out['sweep']))
    return out


if __name__ == '__main__':
    main()
