"""Parity and timing of the decode-step attend kernels against their plain
twins: the port's counterpart of ``tools/bench_beam_attend.py``, with
``mha_step_fused`` beside it.

    python -m captioning_tpu_torch.tools.bench_beam_attend \\
        [--device cuda|cpu] [--batch 1024] [--dk 64] [--dtype bfloat16] \\
        [--iters 30]

On the GPU by default (``--device cpu`` runs the wrappers' plain twins,
e.g. ``--batch 4 --dk 8`` as a quick check).  Four parts, each raising
``AssertionError`` on a mismatch:

1. ``attend_merged`` at ``--batch`` images x beam 5, 8 heads, T 21, t0 12,
   against its twin, and against the same values in the head-major
   ``[N, h, T, dk]`` layout attended by ``anc_attend_ref`` (the plain
   ancestry attend over head-major caches, a one-layer stack);
2. the shape sweep ``(bw, n_img, t0)`` through ``attend_write_merged``
   (T padded to 24) and ``attend_merged`` (T 21), against the write and
   the twin;
3. six decode steps from zero caches through ``attend_write_merged``,
   carried in a Python loop (the ancestry row of step t names the row's own
   slot, as the decode sets it), against the write and the twin;
4. ``mha_step_fused`` at N = batch x 5, 8 heads, T 21, t 12, against its
   twin.

Then it prints the kernels' and the twins' times: CUDA events on the GPU,
the host clock on the CPU, where both columns time the twin; and the t
sweep: each attend's time at t 0 / 12 / 20 of T 21 and at t 47 of T 48
(``SWEEP_T``), by CUDA-graph replay on the GPU (the host clock on the
CPU), which gives its fixed cost and per-step slope.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops import beam_attend as ba
from ..ops import mha_step as ms
from ..ops.anc_attend import anc_attend_ref
from .bench_topk import replay_ms

H, T, T0, BW = 8, 21, 12, 5
# the JAX bench's sweep (bw, n_img, t0)
SWEEP = ((8, 2, 0), (8, 2, 3), (8, 8, 3), (5, 8, 3), (5, 64, 0), (5, 64, 12),
         (1, 64, 3), (8, 64, 3))
STEPS = 6
# the t sweep: (T, t)
SWEEP_T = ((21, 0), (21, 12), (21, 20), (48, 47))


def tolerance(dtype) -> float:
    """Ancestry attend, kernel vs twin: float32 1e-5 (the same math up to
    summation order); bf16 0.05: the kernels round the scores where the
    twin does, and keep p in float32 where the twin rounds it to bf16."""
    return 1e-5 if dtype == torch.float32 else 0.05


def mha_tolerance(dtype) -> float:
    """``mha_step_fused`` vs its twin: float32 1e-5; bf16 0.1, since the
    kernel keeps the scores in float32 (as the Pallas body does) where the
    twin rounds the product and the scaled score to bf16 (each up to ~0.016
    at these inputs' |scores| < 4) and then p."""
    return 1e-5 if dtype == torch.float32 else 0.1


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _check(what, err, atol):
    if not err <= atol:
        raise AssertionError('%s: max err %g > %g' % (what, err, atol))


def timer(device, iters):
    """Mean time of ``fn`` over ``iters`` calls after one warm-up: CUDA
    events on the GPU, the host clock on the CPU."""
    def run(fn):
        fn()
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1000 / iters
    return run


def sweep_timer(device, iters):
    """``timer``, but by CUDA-graph replay on the GPU."""
    if device.type == 'cuda':
        return lambda fn: replay_ms(fn, iters)
    return timer(device, iters)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    p.add_argument('--batch', type=int, default=1024)
    p.add_argument('--dk', type=int, default=64)
    p.add_argument('--dtype', default='bfloat16',
                   choices=('bfloat16', 'float32'))
    p.add_argument('--iters', type=int, default=30)
    a = p.parse_args(argv)
    if a.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run the plain twins)')
    device = torch.device(a.device)
    dtype = getattr(torch, a.dtype)
    atol = tolerance(dtype)
    dk, D = a.dk, H * a.dk
    N = a.batch * BW
    g = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def ancestry(n, t_len, bw):
        return torch.randint(0, bw, (n, t_len), generator=g, device=device,
                             dtype=torch.int32)

    def own_slots(n, bw):
        return torch.arange(n, device=device, dtype=torch.int32) % bw

    out = {}

    # 1. attend_merged against its twin and the head-major layout
    q, k, v, anc = rnd(N, D), rnd(N, T, D), rnd(N, T, D), ancestry(N, T, BW)
    got = ba.attend_merged(q, k, v, anc, T0, bw=BW, h=H)
    want = ba.attend_merged_ref(q, k, v, anc, T0, bw=BW, h=H)
    k_o = k.reshape(N, T, H, dk).transpose(1, 2).contiguous()
    v_o = v.reshape(N, T, H, dk).transpose(1, 2).contiguous()
    old = anc_attend_ref(k_o[:, None], v_o[:, None], q, anc, 0, T0, BW)
    e_twin, e_old = _err(got, want), _err(got, old)
    _check('attend_merged vs twin', e_twin, atol)
    _check('attend_merged vs head-major attend', e_old, atol)
    print('attend_merged N=%d T=%d t0=%d: max|d| vs twin %.3g, vs the '
          'head-major layout %.3g' % (N, T, T0, e_twin, e_old))
    out['attend_merged'] = {'max_err': e_twin}

    # 2. the shape sweep through both attends; the write kernel's ancestry
    # row t0 names the row's own slot, as the decode sets it
    Tp = -(-T // 8) * 8
    for bw, n_img, t0 in SWEEP:
        Ns = n_img * bw
        qs, kn, vn = rnd(Ns, D), rnd(Ns, D), rnd(Ns, D)
        ks, vs, ancs = rnd(Ns, Tp, D), rnd(Ns, Tp, D), ancestry(Ns, Tp, bw)
        ancs[:, t0] = own_slots(Ns, bw)
        a_bw = ancs if bw > 1 else None
        k1, v1, k2, v2 = ks.clone(), vs.clone(), ks.clone(), vs.clone()
        ctx = ba.attend_write_merged(qs, k1, v1, kn, vn, a_bw, t0, bw=bw,
                                     h=H)
        ref = ba.attend_write_merged_ref(qs, k2, v2, kn, vn, a_bw, t0, bw=bw,
                                         h=H)
        e_w = _err(ctx, ref)
        same = torch.equal(k1, k2) and torch.equal(v1, v2)
        kc, vc, ac = (x[:, :T].contiguous() for x in (ks, vs, ancs))
        ac = ac if bw > 1 else None
        e_a = _err(ba.attend_merged(qs, kc, vc, ac, t0, bw=bw, h=H),
                   ba.attend_merged_ref(qs, kc, vc, ac, t0, bw=bw, h=H))
        print('  bw=%d n_img=%-3d t0=%-2d  write+attend %.4g (caches %s), '
              'attend %.4g' % (bw, n_img, t0, e_w,
                               'identical' if same else 'DIFFER', e_a))
        _check('sweep attend_write_merged bw=%d n_img=%d t0=%d'
               % (bw, n_img, t0), e_w, atol)
        _check('sweep attend_merged bw=%d n_img=%d t0=%d' % (bw, n_img, t0),
               e_a, atol)
        if not same:
            raise AssertionError('sweep bw=%d n_img=%d t0=%d: the written '
                                 'caches differ' % (bw, n_img, t0))

    # 3. the in-loop carry from zero caches
    Nc = 64 * BW
    anc_c = ancestry(Nc, Tp, BW)
    kk = [torch.zeros(Nc, Tp, D, device=device, dtype=dtype)
          for _ in range(4)]
    errs = []
    for t in range(STEPS):
        qs, kn, vn = rnd(Nc, D), rnd(Nc, D), rnd(Nc, D)
        anc_t = anc_c.clone()
        anc_t[:, t] = own_slots(Nc, BW)
        ctx = ba.attend_write_merged(qs, kk[0], kk[1], kn, vn, anc_t, t,
                                     bw=BW, h=H)
        ref = ba.attend_write_merged_ref(qs, kk[2], kk[3], kn, vn, anc_t, t,
                                         bw=BW, h=H)
        errs.append(_err(ctx, ref))
        _check('carry step %d' % t, errs[-1], atol)
    if not (torch.equal(kk[0], kk[2]) and torch.equal(kk[1], kk[3])):
        raise AssertionError('carry: the written caches differ')
    print('in-loop carry per-step max|d|: %s' % ['%.4g' % e for e in errs])

    # 4. mha_step_fused
    qh, kn, vn = rnd(N, H, dk), rnd(N, H, dk), rnd(N, H, dk)
    kc, vc = rnd(N, H, T, dk), rnd(N, H, T, dk)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = ms.mha_step_fused(qh, kn, vn, k1, v1, T0)[0]
    want = ms.mha_step_ref(qh, kn, vn, k2, v2, T0)[0]
    e_m = _err(got, want)
    _check('mha_step_fused vs twin', e_m, mha_tolerance(dtype))
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        raise AssertionError('mha_step_fused: the written caches differ')
    print('mha_step_fused N=%d T=%d t=%d: max|d| vs twin %.3g, caches '
          'identical' % (N, T, T0, e_m))
    out['mha_step_fused'] = {'max_err': e_m}

    # times at the main shapes, on the inputs of parts 1 and 4
    run = timer(device, a.iters)
    out['attend_merged'].update(
        ms=run(lambda: ba.attend_merged(q, k, v, anc, T0, bw=BW, h=H)),
        plain_ms=run(lambda: ba.attend_merged_ref(q, k, v, anc, T0, bw=BW,
                                                  h=H)))
    out['mha_step_fused'].update(
        ms=run(lambda: ms.mha_step_fused(qh, kn, vn, k1, v1, T0)),
        plain_ms=run(lambda: ms.mha_step_ref(qh, kn, vn, k2, v2, T0)))
    clock = ('CUDA events, %s' % torch.cuda.get_device_name(device)
             if device.type == 'cuda' else 'host clock, CPU: both the twin')
    for name, r in out.items():
        print('%s: kernel %.4f ms, twin %.4f ms (%s, %s)'
              % (name, r['ms'], r['plain_ms'], a.dtype, clock))
    out['sweep'] = sweep(rnd, ancestry, N, D, dk, sweep_timer(device, a.iters))
    print('t sweep, kernel ms (%s, %s): %s'
          % (a.dtype, 'CUDA-graph replay' if device.type == 'cuda' else clock,
             out['sweep']))
    return out


def sweep(rnd, ancestry, N, D, dk, run):
    """Each attend at the (T, t) of ``SWEEP_T``, bw 5: {name: {'T %d t %d':
    ms}}."""
    times = {'attend_merged': {}, 'mha_step_fused': {}}
    for T_s, t in SWEEP_T:
        key = 'T %d t %d' % (T_s, t)
        q, k, v, anc = rnd(N, D), rnd(N, T_s, D), rnd(N, T_s, D), ancestry(
            N, T_s, BW)
        times['attend_merged'][key] = run(
            lambda: ba.attend_merged(q, k, v, anc, t, bw=BW, h=H))
        del k, v
        qh, kn, vn = rnd(N, H, dk), rnd(N, H, dk), rnd(N, H, dk)
        kc, vc = rnd(N, H, T_s, dk), rnd(N, H, T_s, dk)
        times['mha_step_fused'][key] = run(
            lambda: ms.mha_step_fused(qh, kn, vn, kc, vc, t))
        del kc, vc
    return times


if __name__ == '__main__':
    main()
