#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``captioning_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the six CUDA sources of ``captioning_tpu_torch/csrc`` (one nvcc
   per source, all started together);
3. hold each kernel against its plain PyTorch twin on the card at the main
   paths' shapes (B1: N = 5120 beam rows and N = 1024 greedy rows,
   D = 512, 8 heads, Tp in {8, 24, 32, 48}, bw in {5, 1}; B2: V1 = 9488,
   k in {5, 1}, temperature 0.8, UNK bias on; B3: 1024 images, bw in
   {1, 5}, M = 36, H = 1000, A = 512; the maxout gates: N in {5120, 1024},
   H in {512, 1000}; the top-k: [1024, 5 x 9488] and [1024, 9488], k in
   {1, 2, 3, 5, 8, 16}, on random, integer-tied, NEG-masked, ascending,
   descending and plateau rows), in float32 with tight tolerances and in
   bf16 with stated ones, plus ragged small shapes (the top-k
   bit-identical everywhere), plus shapes that stress the redesigns of
   B1, B2 and B3 (B1: t0 past the 32-step ancestry window of
   Tp 48, t0 = 0, head widths that take 8- and 4-byte vectors or two
   vectors a lane; B2: N 1000 and 37 against its 128-row block, k 16, V1
   ragged against its 64-wide tile, D 1024 on its 64-row block; B3: M 37
   and 100 against its ring's stages, rows of no whole 16 bytes, bw 2 / 3
   / 8, float32 features at full width, M = MAX_M, and its bf16 tanh table
   over all 65,536 inputs); and time each against its twin; time B2 (k 1
   / 5 / 16, and the greedy shape), B1 (t0 0 / 10 / 16 / 20), B3 (beam
   and greedy, the greedy bound beside it) and the top-k (k 1 / 5 / 16,
   and ascending, descending, plateau and NEG-masked rows) by CUDA-graph
   replay too; and print the cuBLAS
   time of B2's product alone (``x @ w.T``, bf16) on a line of its own: a
   floor for the GEMM part, not the same function;
4. build the full-width transformer (6 + 6 layers, d_model 512, d_ff 2048,
   8 heads, vocab 9487 + 1, 36 x 2048 features, max length 20) from the
   port's own init with a seeded generator;
5. decode through ``Captioner`` — beam 5 at B = 1024 and greedy at
   B = 1024, bf16 — with the kernels' launch counters reset just before
   and required to have grown just after; report cap/s; then decode a
   small batch in float32 with the kernels (CUDA) and with the twins (CPU)
   and report the token agreement;
6. the same for the full-width UpDown of ``configs/updown/updown.yml``
   (rnn_size 1000, input_encoding_size 1000, att_hid_size 512, 36 x 2048
   bottom-up features and their mean as the fc feature), whose attention
   runs kernel B3 on every step and whose beam selects through the top-k
   kernel; one more beam batch captures the candidate table of its middle
   step, on which the top-k is checked and timed by graph replay;
7. the same for StackAtt at the ``opts.py`` widths (rnn_size,
   input_encoding_size and att_hid_size 512; B3, the maxout gates three
   times a step, the top-k in beam) and for NewFC of ``configs/fc.yml``
   (fc 2048, widths 512; the maxout gates, the top-k in beam);
8. the strided attend of ``csrc/attend.cu`` behind ``attend_merged``,
   ``mha_step_fused`` and ``anc_attend``: each held against its twin at
   the benches' shapes (N 5120, 8 heads, dk 64, T 21; the stacked cache
   with 6 layers) and at ragged ones, in float32 and bf16, and at shapes
   that stress its redesign (t on both sides of the 32-step ancestry
   window at T 48, T 70; dk 8 / 10 / 254 / 256 on 16-, 8- and 4-byte
   vectors, several a lane, several warps a row; bw 8; odd N), and timed
   against its twin, by its launch loop and by CUDA-graph replay; then the
   two bench entry points (``captioning_tpu_torch.tools.bench_beam_attend``
   and ``bench_anc_attend``) at full size with their t sweeps (graph
   replay at t 0 / 12 / 20 of T 21 and t 47 of T 48), with every launch
   counter reset just before and each kernel they run required to have
   grown just after;
9. XE training through the port's ``Trainer`` (``modules/trainer.py``):
   (a) float32 agreement: one ``xe_step`` of UpDown, StackAtt, NewFC and
   the transformer at full width, 2 images x 5 captions, dropout 0, from
   one seeded init and batch, on the card (the kernels' forward, their
   backward by recompute) and on the CPU (the twins): the loss within
   1e-5 relative, every gradient within 1e-4 of its tensor's largest
   magnitude, with TF32 off (a bias added to every score of a softmax
   row has an exact gradient of 0: there both devices' values, rounding,
   stay within 1e-6 of the model's largest gradient); (b) UpDown of ``configs/updown/updown.yml``
   and StackAtt at the ``opts.py`` widths, batch 10 x 5, label length 16,
   adam 5e-4, clip by value 0.1, ``ss_prob`` 0.25 (the ramp's maximum),
   dropout 0.5: 2 warm-up steps, then 10 steps on one seeded batch with
   the launch counters reset just before, B3 required at one forward
   launch per attention head and time step (17 time steps: the input is
   ``labels[..., :-1]``) and B5 at one per maxout cell and time step, the
   backward launching none; (c) the transformer of
   ``configs/transformer/transformer.yml`` with noam (warmup 20000) and
   dropout 0.1, the same way, no kernel launched.  The last of the 10
   steps draws the first's dropout and sampling again (the generator
   state restored), so its loss, below the first's, shows the updates; each
   run prints its median step time and spread (CUDA events and the host
   wall) and its peak memory;
10. the rest of the decoding engine through ``Captioner`` at B = 1024,
   bf16 (``profile_decode.MODES``, a vocab where every fourth word is a
   function word that ``remove_bad_endings`` bans before EOS): the
   transformer's general beam body at one group with
   ``decoding_constraint`` and ``remove_bad_endings`` (beam 5: B1, B6),
   diverse beam (beam 6 in 3 groups, ``diversity_lambda`` 0.5: B6; the
   per-row step is plain), ``sample_n`` 5 by sample, top-3, top-0.9 and
   gumbel (B1), and beam 5 with the winner-logprob replay (B1, B2);
   UpDown's diverse beam (B3, B6) and ``sample_n`` 5 sampling (B3); NewFC's
   diverse beam (B5, B6: the per-row FC seeding) and diverse greedy in 5
   groups (B5).  Each mode with the launch counters reset just before and
   its kernels required to have grown just after, its cap/s (captions
   returned) on a line of its own, then its f32 agreement at B = 8,
   kernels (CUDA) against twins (CPU), the sampling noise drawn once on
   the CPU and fed to both; and the top-k held bit for bit against its
   twin on a candidate table of the constrained general body, which holds
   -inf;
11. SCST and structure training through the port's ``Trainer``: (a)
   float32 agreement: one ``sc_fused_step`` and one ``struc_fused_step``
   (new_self_critical) of UpDown and of the transformer at full width, 2
   images x 5 samples, dropout 0, TF32 off, learning rate 0, on the card
   (kernels) and on the CPU (twins), the sampling noise drawn once on the
   CPU and fed to both: ``sc_decode``'s greedy and sampled sequences
   identical, the rewards within 1e-5, each step's loss and gradients as
   phase 9 holds them; (b) the fused SCST step of
   ``configs/updown/updown_sc.yml`` and ``configs/transformer/
   transformer_sc.yml`` (``profile_train.RL``) at batch 10 x 5 (the
   transformer also at 50 x 5, the reference bench's SCST shape), decode
   length 20, float32, 5 references of label length 16 an image, the
   CIDEr-D df table built as ``scripts/prepro_ngrams.py`` builds it over a
   seeded random corpus of 5000 images x 5 references in the COCO
   vocabulary: 1 warm-up step, then 4 with the launch counters reset
   just before (phase 13 times the step), B3 required on the UpDown
   baseline and sample (at least 21 launches a step, no other kernel; the
   baseline runs all 20 steps: 40), B1 and B2 on the transformer's
   greedy baseline (B1 six times B2's count, no other kernel); each run
   prints its median s/iter and spread (CUDA events and host wall), its
   peak memory, and an ``sc_decode`` scored on the card and by the python
   CiderD on the CPU (within 1e-4);
12. the CUDA-graph decodes (``engine/graphs.py``): the transformer,
   UpDown, StackAtt and NewFC, beam 5 and greedy at B = 1024, bf16,
   through ``sample_beam_graphed`` / ``sample_stats_graphed`` and through
   the eager entries: each entry's capture time and memory, the kernels
   its graphs captured (B1 and B2 for the transformer, B3 for UpDown and
   StackAtt, B5 for StackAtt and NewFC, B6 in the RNN beams: required), no
   wrapper launch on a graph batch, 3 walls a route taken in turns with
   their CUDA-event time, the launches the replays ran (each graph's
   captured calls times its replays; required), graph against eager
   tokens (a bf16 difference reported with its top-2 gap); float32 graph
   against eager tokens, required identical, at B = 8 for the four models
   and at B = 1024 for the transformer; then the port's bench
   (``captioning_tpu_torch/tools/bench.py``) at full size: its headline
   JSON line and the four suite rows, every row required;
13. the CUDA-graph train steps (``Trainer.xe_step_graphed``,
   ``sc_fused_step_graphed``, ``sc_grad_step_graphed``;
   ``engine.graphs.GraphTrainStep``) against the eager ones, float32,
   TF32 off, from one init, batch and generator seeds a case: XE of
   UpDown, StackAtt and the transformer at 10 x 5, L 16 (phase 9's
   options); the fused SCST step of UpDown and the transformer at 10 x 5
   and of the transformer at 50 x 5 (phase 11's); UpDown's SCST grad step
   over one ``sc_decode`` at 10 x 5.  For each: 3 steps a route with the
   sampled and greedy sequences identical, loss and reward within 1e-6
   relative, then every parameter and Adam moment within 1e-5 of its
   tensor's largest magnitude; 20 timed steps a route in turns (blocks
   of 5), their medians by host wall and CUDA events, the routes' peak
   memory and the graph's pool; one profiled step a route (device busy,
   idle share); the kernels the graph holds required (B3 17 a step for
   UpDown XE, B3 34 and B5 51 for StackAtt, none for the transformer; B3
   40 for UpDown SCST, B1 120 and B2 20 for the transformer's, B3 20 for
   the grad step) and equal to the eager step's launches, no wrapper
   launch on a replay, the replays' launches captures x replays;
14. the last three model keys: AoANet of ``configs/aoa.yml`` (rnn
   and word embedding 1024, 8 heads, the 6-layer refiner with the AoA gate,
   the AoA decoder), att2in and ShowTell at the ``opts.py`` widths, 36 x
   2048 features, COCO vocab 9487 + 1: beam 5 and greedy at B = 1024, bf16,
   eager and graphed (the eager path's kernels required on its first
   batch, the graphs' held and replayed ones required: B6 in the beams, B3
   and B5 on att2in; no wrapper launch on a graph batch; graph tokens
   required equal to eager; 3 batches a route in turns, cap/s at each
   route's median, one profiled batch a route: busy and idle share; the
   capture time and the graph cache), then float32 at B = 8, the card's
   tokens required equal to the CPU's; AoANet's XE step (label smoothing
   0.2, ``ss_prob`` 0.25) and fused SCST step (``configs/aoa_sc.yml``)
   at 10 x 5, graph against eager by phase 13's rules; one float32 XE
   step of att2in and of ShowTell, card against CPU by phase 9's rules
   (B3 and B5 required on att2in's); B3 as att2in calls it (H 2048, the
   raw float32 regions with bf16 queries, bw 5 and 1; and bf16 regions)
   held against its twin and timed beside its bound;
15. bf16 training with float32 master weights (``--compute_dtype
   bfloat16``): one bf16 XE step of StackAtt at full width, card (B3 34
   and B5 51 launches) against the CPU's twins, the loss within 1e-2
   relative and each gradient within 2e-2 relative L2 plus twice its
   bf16-to-float32 distance on the CPU (PERF.md's bf16 tolerance), and one
   float32 XE step of UpDown, card against CPU by phase 9's rules; then
   the XE and fused SCST steps of the transformer, UpDown and AoANet at
   10 x 5, L 16, bf16: an eager and a graphed trainer from one init, 3
   steps each bit for bit (sequences, loss, reward, the float32
   parameters and Adam moments, the bf16 copies), parameters, gradients
   and moments float32, the graph holding phase 13's kernels; 3 timed
   eager and 10 timed graph steps (medians by host wall and CUDA events,
   peak memory, the graph's pool) beside 10 graph steps of the same step
   in float32; UpDown's greedy decode through a graph captured before the
   updates gives, after them, a fresh captioner's tokens from the trained
   masters.

Each decode mode requires the kernels its path runs: the top-k only in
beam (the RNN plain-step route; the transformer's fused route selects in
B2's epilogue).  Phases 5-7 and 10 decode through the eager entries,
whose wrappers count every launch; phase 12's and phase 13's graphs are
counted by captures and replays.

The last two lines are the kernels' JSON record (for each of the eight:
launches on its path, counted by its wrapper, where a call that a CUDA
graph captures counts nothing and the graph's replays never pass the
wrapper; max error against its twin, kernel and twin ms, the
bound of the timed call and what sets it, and the time of a library call
computing the same function where there is one) and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters):
    """Mean device time of ``fn`` with the host taken out: ``iters`` calls
    captured in one CUDA graph, replayed between CUDA events (for kernels
    of a few microseconds, whose launch loop the host would pace)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The least time the card could take for a kernel's work: the larger of
# the bytes it must move (each input byte these inputs need read once, each
# output byte written once) over 3.35 TB/s, and its operations over the
# card's peak for their type (H100 SXM data sheet, dense).  Where the work depends on the data (the
# ancestry gathers), the bytes are those this run's tables need.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR = 989e12          # bf16 products on the tensor cores
PEAK_F32 = 67e12                   # float32 outside the tensor cores


def bound(nbytes, flops, peak):
    """(bound ms, 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def distinct_entries(torch, anc, bw, upto):
    """How many distinct (slot, time) cache entries an ancestry gather over
    the times j < ``upto`` reads: row r reads slot (r // bw) * bw +
    anc[r, j]."""
    if upto <= 0:
        return 0
    N, dev = anc.shape[0], anc.device
    slot = (torch.arange(N, device=dev) // bw * bw)[:, None] + anc[:, :upto]
    keys = slot.long() * upto + torch.arange(upto, device=dev)
    return torch.unique(keys).numel()


def sdpa_ancestry(torch, q, k, v, anc, t0, bw, h):
    """The ancestry attend as one call of the library's attention, for its
    time beside the kernels (the port never calls it): q [N, D] viewed
    [nb, h, bw, dk]; the caches [N, T, D] viewed [nb, h, bw * T, dk], no
    copy, since slot and time are adjacent dims; a boolean mask, built
    here and so not timed, that lets query i of block b see key (s, j)
    where s == anc[b * bw + i, j] and j <= t0.  Returns the call and a
    function that lays its output out as ctx [N, D]."""
    N, T, D = k.shape
    nb, dk = N // bw, D // h
    q4 = q.view(nb, bw, h, dk).transpose(1, 2)
    k4 = k.view(nb, bw * T, h, dk).transpose(1, 2)
    v4 = v.view(nb, bw * T, h, dk).transpose(1, 2)
    sel = torch.nn.functional.one_hot(anc.long(), bw).bool()   # [N, T, s]
    sel &= (torch.arange(T, device=k.device) <= t0)[:, None]
    mask = sel.view(nb, bw, T, bw).permute(0, 1, 3, 2).reshape(
        nb, 1, bw, bw * T)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(q4, k4, v4, attn_mask=mask)
    return call, lambda o: o.transpose(1, 2).reshape(N, D)


def library_ancestry(torch, q, k, v, anc, t0, bw, h, ctx, what):
    """Time ``sdpa_ancestry`` and hold its output against the kernel's
    ``ctx`` on the same caches: within ``bench_beam_attend.mha_tolerance``
    (bf16 0.1: the library's bf16 rounding is its own)."""
    from captioning_tpu_torch.tools.bench_beam_attend import mha_tolerance
    call, layout = sdpa_ancestry(torch, q, k, v, anc, t0, bw, h)
    err = (layout(call()).float() - ctx.float()).abs().max().item()
    if not err <= mha_tolerance(q.dtype):
        raise AssertionError('%s: the library attention differs from the '
                             'kernel by %g' % (what, err))
    return cuda_ms(call, 50)


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def check_beam_attend(torch, ba, N, D, h, bw, Tp, t0, dtype, atol, seed):
    """Kernel vs twin on the same inputs; returns the max |ctx| error."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    q, kn, vn = rnd(N, D), rnd(N, D), rnd(N, D)
    k, v = rnd(N, Tp, D), rnd(N, Tp, D)
    anc = None
    if bw > 1:
        anc = torch.randint(0, bw, (N, Tp), generator=g, device=dev,
                            dtype=torch.int32)
        anc[:, t0] = torch.arange(N, device=dev, dtype=torch.int32) % bw
    k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
    got = ba.attend_write_merged(q, k1, v1, kn, vn, anc, t0, bw=bw, h=h)
    want = ba.attend_write_merged_ref(q, k2, v2, kn, vn, anc, t0, bw=bw,
                                      h=h)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not (err <= atol and torch.equal(k1, k2) and torch.equal(v1, v2)):
        raise AssertionError('attend_write_merged %s N=%d bw=%d Tp=%d t0=%d:'
                             ' max err %g > %g or caches differ'
                             % (dtype, N, bw, Tp, t0, err, atol))
    return err


def _margin_inputs(torch, N, D, V1, dtype, g, integer):
    dev = 'cuda'
    if integer:
        # multiples of 1/8 with small integer numerators: every product and
        # sum is exact in float32, so the logits are identical under any
        # summation order and exact ties are frequent
        x = torch.randint(-2, 3, (N, D), generator=g, device=dev) / 8.0
        w = torch.randint(-1, 2, (V1, D), generator=g, device=dev).float()
        b = torch.randint(-2, 3, (V1,), generator=g, device=dev) / 8.0
        return x.to(dtype), w.to(dtype), b.to(dtype)
    # margins by construction: each row gets 5 distinct "hot" columns
    # (never the UNK column) whose logits are solved to 7.5, 6.5, .., 3.5;
    # the other logits stay ~N(0, 0.6), max ~2.3 over 9487 columns.  So the
    # top-5 gaps are ~1 and |logit| < 8 keeps one bf16 ulp <= 0.03.
    x = torch.randn(N, D, generator=g, device=dev)
    w = torch.randn(V1, D, generator=g, device=dev) * 0.011
    b = torch.randn(V1, generator=g, device=dev) * 0.02
    target = torch.tensor([7.5, 6.5, 5.5, 4.5, 3.5], device=dev)
    hot = torch.rand(N, V1 - 1, generator=g, device=dev).argsort(1)[:, :5]
    wh = w[hot]                                             # [N, 5, D]
    cur = (wh @ x[..., None])[..., 0] + b[hot]
    alpha = torch.linalg.solve(wh @ wh.transpose(1, 2), target - cur)
    x = x + (wh.transpose(1, 2) @ alpha[..., None])[..., 0]
    return x.to(dtype), w.to(dtype), b.to(dtype)


def check_logit_topk(torch, lt, N, D, V1, k, dtype, seed, temp=0.8,
                     unk_bias=-1000.0, unk_idx=None):
    """Kernel vs twin; returns the max |top value| error.

    float32: exact-logit inputs, so indices must be identical on every row
    (ties included), values / ent within 1e-4, row_sum within rtol 1e-5
    (a sum of V1 terms near 1e5 in float32).  bf16: the kernel and the twin
    round the product to bf16 from different float32 sums, so a logit can
    differ by one bf16 ulp (0.03 at |logit| < 8, 0.04 after / 0.8): top
    values (sorted) within 0.08, ent within 0.05, row_sum within rtol 1e-3,
    indices identical on every row whose float32 top-(k+1) gaps all exceed
    0.1 (the inputs are built so that nearly all do), and the top-1 index
    identical on every row."""
    unk_idx = V1 - 1 if unk_idx is None else unk_idx
    g = torch.Generator(device='cuda').manual_seed(seed)
    integer = dtype == torch.float32
    x, w, b = _margin_inputs(torch, N, D, V1, dtype, g, integer)
    got = lt.logit_topk(x, w, b, temp, unk_bias, k=k, unk_idx=unk_idx)
    want = lt.logit_topk_ref(x, w, b, temp, unk_bias, k=k, unk_idx=unk_idx)
    torch.cuda.synchronize()
    verr = (got[0] - want[0]).abs().max().item()
    eerr = (got[3] - want[3]).abs().max().item()
    rerr = ((got[2] - want[2]).abs() / want[2].abs().clamp_min(1)).max()
    rerr = rerr.item()
    what = 'logit_topk %s N=%d V1=%d k=%d' % (dtype, N, V1, k)
    if integer:
        same = torch.equal(got[1], want[1])
        if not (same and verr <= 1e-4 and eerr <= 1e-4 and rerr <= 1e-5):
            raise AssertionError('%s: idx equal %s, value err %g, ent err %g,'
                                 ' row_sum rel err %g' % (what, same, verr,
                                                          eerr, rerr))
        return verr, 1.0
    ref = lt.logit_topk_ref(x.float(), w.float(), b.float(), temp, unk_bias,
                            k=k + 1, unk_idx=unk_idx)[0]
    margin = (ref[:, :-1] - ref[:, 1:]).min(1).values > 0.1
    same_rows = (got[1] == want[1]).all(1)
    top1 = torch.equal(got[1][:, 0], want[1][:, 0])
    ok = (bool(same_rows[margin].all()) and top1 and verr <= 0.08
          and eerr <= 0.05 and rerr <= 1e-3)
    share = margin.float().mean().item()
    if not ok:
        raise AssertionError('%s: margin rows %.3f idx equal %s top1 %s, '
                             'value err %g, ent err %g, row_sum rel err %g'
                             % (what, share, bool(same_rows[margin].all()),
                                top1, verr, eerr, rerr))
    return verr, share


def phase_kernels(torch, ba, lt):
    errs = {'attend_write_merged': 0.0, 'logit_topk': 0.0}
    # beam 5 at B = 1024 gives N = 5120 rows; greedy gives N = 1024
    D, h = 512, 8
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 0.05)):
        for bw, N in ((5, 5120), (1, 5120), (1, 1024)):
            for Tp in (8, 24, 32, 48):
                for t0 in sorted({0, Tp // 2, min(Tp - 1, 20)}):
                    e = check_beam_attend(torch, ba, N, D, h, bw, Tp, t0,
                                          dtype, atol, seed=Tp * 10 + bw)
                    if dtype == torch.bfloat16 and bw == 5 and Tp == 24:
                        errs['attend_write_merged'] = max(
                            errs['attend_write_merged'], e)
            log('  attend_write_merged %s N=%d bw=%d: ok' % (dtype, N, bw))
    # ragged: odd row count, head width 32, Tp not a multiple of 8
    check_beam_attend(torch, ba, 37, 96, 3, 1, 13, 12, torch.float32, 1e-5,
                      seed=1)
    check_beam_attend(torch, ba, 36, 96, 3, 4, 13, 7, torch.float32, 1e-5,
                      seed=2)
    log('  attend_write_merged ragged shapes: ok')
    # the redesign's edges: t0 past the ancestry's 32-step window, t0 = 0,
    # and head widths whose bytes take 8- or 4-byte vectors (dk 10, dk 254)
    # or two 16-byte vectors a lane (dk 256 in float32)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 0.05)):
        for N, Dh, hh, bw, Tp, t0 in ((5120, 512, 8, 5, 48, 32),
                                      (5120, 512, 8, 5, 48, 47),
                                      (1024, 512, 8, 1, 48, 40),
                                      (5120, 512, 8, 5, 24, 0),
                                      (35, 30, 3, 5, 70, 69),
                                      (40, 512, 2, 5, 40, 39),
                                      (36, 508, 2, 4, 9, 8)):
            check_beam_attend(torch, ba, N, Dh, hh, bw, Tp, t0, dtype, atol,
                              seed=Tp + t0 + bw)
    log('  attend_write_merged stress shapes (Tp 48 with t0 32 / 40 / 47, '
        't0 0, dk 10 / 254 / 256, Tp 70): ok')
    V1 = 9488
    for dtype in (torch.float32, torch.bfloat16):
        for k, N in ((5, 5120), (1, 5120), (1, 1024)):
            e, share = check_logit_topk(torch, lt, N, D, V1, k, dtype,
                                        seed=k)
            if dtype == torch.bfloat16 and k == 5:
                errs['logit_topk'] = e
            log('  logit_topk %s N=%d k=%d: ok (max value err %.3g, rows '
                'with index margins %.3f)' % (dtype, N, k, e, share))
    check_logit_topk(torch, lt, 37, 96, 1001, 3, torch.float32, seed=3,
                     unk_idx=-1, unk_bias=0.0, temp=1.0)
    check_logit_topk(torch, lt, 37, 96, 1001, 16, torch.float32, seed=4,
                     unk_idx=5)
    check_logit_topk(torch, lt, 37, 96, 1001, 5, torch.bfloat16, seed=5)
    log('  logit_topk ragged shapes: ok')
    # the redesign's edges: N off the bf16 kernel's 128-row block, k 16
    # (the longest per-thread list), V1 ragged against its 64-wide tile,
    # D 1024 on its 64-row block, temperature 1 without the UNK bias
    for dtype in (torch.float32, torch.bfloat16):
        check_logit_topk(torch, lt, 1000, D, V1, 16, dtype, seed=6)
        check_logit_topk(torch, lt, 37, D, 1001, 16, dtype, seed=7)
    check_logit_topk(torch, lt, 300, 1024, 3001, 5, torch.bfloat16, seed=8)
    check_logit_topk(torch, lt, 1000, D, V1, 5, torch.bfloat16, seed=9,
                     temp=1.0, unk_bias=0.0, unk_idx=-1)
    log('  logit_topk stress shapes (N 1000 / 37, k 16, V1 1001, D 1024, '
        'temp 1): ok')
    return errs


def _aa_inputs(torch, nb, bw, M, H, A, dtype, seed, ragged, att_dtype=None):
    """Attention inputs at the scales of a trained model's step: att ~
    N(0, 1), keys and queries ~ N(0, 0.5^2), alpha_net U(+-1/sqrt(A)).
    ``att_dtype`` (default ``dtype``) is the features' type."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale
                ).to(dtype)
    att_h = rnd(nb * bw, A, scale=0.5)
    att = rnd(nb, M, H).to(att_dtype or dtype)
    p_att = rnd(nb, M, A, scale=0.5)
    bound = A ** -0.5
    w = ((torch.rand(A, generator=g, device=dev) * 2 - 1) * bound).to(dtype)
    b = ((torch.rand(1, generator=g, device=dev) * 2 - 1) * bound).to(dtype)
    mask = torch.ones(nb, M, device=dev)
    if ragged:
        # per-image region counts 1..M, and one image with none valid
        n = torch.randint(1, M + 1, (nb,), generator=g, device=dev)
        mask = (torch.arange(M, device=dev)[None] < n[:, None]).float()
        mask[nb // 2] = 0
    return att_h, att, p_att, mask, w, b


def bf16_tol(torch, att):
    """2 bf16 ulps of max |att|: the kernel and the twin round the same
    products and weights, and sum them in float32 in another order, so
    the output can land one rounding step apart (plus one for a weight
    whose bf16 rounding flips)."""
    return 2.0 * 2.0 ** (torch.floor(torch.log2(att.float().abs().max()))
                         .item() - 7)


def check_additive_attention(torch, aa, nb, bw, M, H, A, dtype, seed,
                             ragged=False, att_dtype=None):
    """Kernel vs twin on the same inputs; returns (max |out| error, atol).
    float32: atol 1e-5; bf16 (also with float32 features): ``bf16_tol``."""
    att_h, att, p_att, mask, w, b = _aa_inputs(torch, nb, bw, M, H, A, dtype,
                                               seed, ragged, att_dtype)
    got = aa.additive_attention_fused(att_h, att, p_att, mask, w, b)
    want = aa.additive_attention_ref(att_h, att, p_att, mask, w, b)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else bf16_tol(torch, att)
    err = (got.float() - want.float()).abs().max().item()
    what = ('additive_attention %s/%s nb=%d bw=%d M=%d H=%d A=%d%s'
            % (dtype, att.dtype, nb, bw, M, H, A,
               ' ragged' if ragged else ''))
    if (not err <= atol or got.shape != want.shape
            or got.dtype != att.dtype):
        raise AssertionError('%s: max err %g > %g' % (what, err, atol))
    if ragged:
        dead = slice((nb // 2) * bw, (nb // 2 + 1) * bw)
        if bool(got[dead].any()):
            raise AssertionError('%s: an all-masked row is not 0' % what)
    return err, atol


def phase_additive_attention(torch, aa):
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for bw in (1, 5):
            e, atol = check_additive_attention(torch, aa, 1024, bw, 36, 1000,
                                               512, dtype, seed=bw)
            if dtype == torch.bfloat16 and bw == 5:
                err = e
            log('  additive_attention %s N=%d bw=%d: ok (max err %.3g, atol '
                '%.3g)' % (dtype, 1024 * bw, bw, e, atol))
    # ragged: odd row count, M = 13, H and A no multiples of 32, ragged
    # masks with one all-masked image
    for dtype in (torch.float32, torch.bfloat16):
        for bw in (1, 5):
            check_additive_attention(torch, aa, 37, bw, 13, 40, 24, dtype,
                                     seed=10 + bw, ragged=True)
    check_additive_attention(torch, aa, 1024, 5, 36, 1000, 512,
                             torch.float32, seed=3, ragged=True)
    # bf16 queries and keys with float32 features (a bf16 model whose
    # masked BatchNorm, use_bn 2, hands float32 features to the head)
    for bw in (1, 5):
        check_additive_attention(torch, aa, 37, bw, 13, 40, 24,
                                 torch.bfloat16, seed=20 + bw, ragged=True,
                                 att_dtype=torch.float32)
    log('  additive_attention ragged shapes and masks, float32 features '
        'with bf16 queries: ok')
    # the redesign's edges: M off the ring's 8-region p stages and 4-region
    # att stages (37, 100) at full width; rows that are no 16-byte multiple
    # (H 13 or A 13 in bf16: the direct kernel, element loads); bw 2, 3, 8;
    # bf16 queries with float32 features at full width; M = MAX_M; H past
    # the ring's 1024 columns (the direct kernel, 16-byte loads)
    f32, bf16 = torch.float32, torch.bfloat16
    for nb, bw, M, H, A, dtype, att_dtype in (
            (1024, 5, 37, 1000, 512, bf16, None),
            (1024, 5, 37, 1000, 512, f32, None),
            (256, 5, 100, 1000, 512, bf16, None),
            (256, 1, 100, 1000, 512, f32, None),
            (37, 5, 13, 13, 24, bf16, None),
            (37, 3, 13, 24, 13, bf16, None),
            (37, 8, 37, 13, 13, f32, None),
            (1024, 2, 36, 1000, 512, bf16, None),
            (1024, 3, 36, 1000, 512, bf16, None),
            (1024, 8, 36, 1000, 512, bf16, None),
            (1024, 5, 36, 1000, 512, bf16, f32),
            (16, 8, aa.MAX_M, 64, 64, bf16, None),
            (16, 8, aa.MAX_M, 40, 24, f32, None),
            (16, 1, aa.MAX_M, 13, 24, bf16, f32),
            (64, 5, 36, 2048, 512, bf16, None),
            (16, 3, 20, 4096, 64, f32, None)):
        check_additive_attention(torch, aa, nb, bw, M, H, A, dtype,
                                 seed=M + H + bw, ragged=True,
                                 att_dtype=att_dtype)
    log('  additive_attention stress shapes (M 37 / 100 at full width, H or '
        'A 13, bw 2 / 3 / 8, float32 features at full width, M %d, H 2048 / '
        '4096): ok' % aa.MAX_M)
    check_tanh_rule(torch, aa)
    return err


def check_tanh_rule(torch, aa):
    """The kernel's bf16 tanh (its shared-memory table and the bounds
    around it) against round_bf16(tanhf(x)) on the card, bit for bit, over
    all 65,536 bf16 inputs (NaN must stay NaN)."""
    x = (torch.arange(65536, dtype=torch.int32, device='cuda')
         .to(torch.int16).view(torch.bfloat16))
    got = aa.tanh_table_rule(x)
    want = torch.tanh(x)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    bad = ((got.view(torch.int16) != want.view(torch.int16))
           & ~(nan & torch.isnan(got)))
    if bool(bad.any()):
        raise AssertionError('additive_attention bf16 tanh: %d of 65536 '
                             'inputs differ from tanhf, first %s'
                             % (int(bad.sum()), [hex(int(v) & 0xFFFF) for v in
                                                 x[bad][:5].view(torch.int16)
                                                 .tolist()]))
    log('  additive_attention bf16 tanh table: all 65536 inputs '
        'bit-identical to round_bf16(tanhf(x))')


def time_additive_attention(torch, aa):
    """Kernel vs twin device time at the UpDown step shapes, bf16, for
    beam 5 (bw = 5) and greedy (bw = 1) at B = 1024; and the kernel's
    time by CUDA-graph replay beside each."""
    out, replay = {}, {}
    nb, M, H, A = 1024, 36, 1000, 512
    for bw in (5, 1):
        args = _aa_inputs(torch, nb, bw, M, H, A, torch.bfloat16,
                          seed=7, ragged=False)
        # att_h, att, p_att, w, b and the output in bf16; the float32 mask
        nbytes = (2 * (nb * bw * A + nb * M * H + nb * M * A + A + 1
                       + nb * bw * H) + 4 * nb * M)
        out[bw] = (cuda_ms(lambda: aa.additive_attention_fused(*args), 50),
                   cuda_ms(lambda: aa.additive_attention_ref(*args), 20),
                   bound(nbytes, nb * bw * M * (3 * A + 2 * H), PEAK_F32))
        replay[bw] = graph_ms(
            torch, lambda: aa.additive_attention_fused(*args), 20)
    return out, replay


def time_kernels(torch, ba, lt):
    """Kernel vs twin device time at the beam-5 B=1024 step shapes, bf16;
    and, for attend_write_merged, the library's attention over the cache
    it wrote (attend only)."""
    g = torch.Generator(device='cuda').manual_seed(7)
    N, D, h, bw, Tp, t0 = 5120, 512, 8, 5, 24, 10
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device='cuda').to(bf)
    q, kn, vn, k, v = (rnd(N, D), rnd(N, D), rnd(N, D), rnd(N, Tp, D),
                       rnd(N, Tp, D))
    anc = torch.randint(0, bw, (N, Tp), generator=g, device='cuda',
                        dtype=torch.int32)
    anc[:, t0] = torch.arange(N, device='cuda', dtype=torch.int32) % bw
    out = {}
    # the cache rows j < t0 it gathers, q / k_new / v_new, ctx and the
    # written entry, anc[:, :t0]
    nbytes = (2 * (3 * N * D + 2 * distinct_entries(torch, anc, bw, t0) * D
                   + 3 * N * D) + 4 * N * t0)
    out['attend_write_merged'] = (
        cuda_ms(lambda: ba.attend_write_merged(q, k, v, kn, vn, anc, t0,
                                               bw=bw, h=h), 50),
        cuda_ms(lambda: ba.attend_write_merged_ref(q, k, v, kn, vn, anc, t0,
                                                   bw=bw, h=h), 50),
        bound(nbytes, 4 * N * D * (t0 + 1), PEAK_F32))
    ctx = ba.attend_write_merged(q, k, v, kn, vn, anc, t0, bw=bw, h=h)
    library = {'attend_write_merged': library_ancestry(
        torch, q, k, v, anc, t0, bw, h, ctx, 'attend_write_merged')}
    V1 = 9488
    x, w, b = rnd(N, D), rnd(V1, D) * 0.1, rnd(V1) * 0.1
    out['logit_topk'] = (
        cuda_ms(lambda: lt.logit_topk(x, w, b, 0.8, -1000.0, k=5,
                                      unk_idx=V1 - 1), 50),
        cuda_ms(lambda: lt.logit_topk_ref(x, w, b, 0.8, -1000.0, k=5,
                                          unk_idx=V1 - 1), 10),
        # x, W, b in bf16; top-5 values and int32 indices, row_sum, ent
        bound(2 * (N * D + V1 * D + V1) + N * 5 * 8 + N * 8,
              2 * N * D * V1, PEAK_BF16_TENSOR))
    # by graph replay (the host taken out): B2 at k 1 / 5 / 16 and at the
    # greedy step (N 1024, k 1, its bound beside it); B1 from t0 0 to 20
    replay = {}
    for n, kk in ((N, 1), (N, 5), (N, 16), (1024, 1)):
        xs = x[:n]
        replay['logit_topk N %d k %d' % (n, kk)] = graph_ms(
            torch, lambda: lt.logit_topk(xs, w, b, 0.8, -1000.0, k=kk,
                                         unk_idx=V1 - 1), 20)
    greedy_bound = bound(2 * (1024 * D + V1 * D + V1) + 1024 * 16,
                         2 * 1024 * D * V1, PEAK_BF16_TENSOR)[0]
    for t in (0, 10, 16, 20):
        anc_t = anc.clone()
        anc_t[:, t] = torch.arange(N, device='cuda', dtype=torch.int32) % bw
        replay['attend_write_merged t0 %d' % t] = graph_ms(
            torch, lambda: ba.attend_write_merged(q, k, v, kn, vn, anc_t, t,
                                                  bw=bw, h=h), 20)
    # the product alone through cuBLAS, a floor for B2's GEMM part (not the
    # same function: no library_ms)
    product = cuda_ms(lambda: x @ w.t(), 50)
    return out, library, (replay, greedy_bound), product


def check_maxout(torch, ml, N, H, dtype, seed, offset=0):
    """Kernel vs twin on the same inputs; returns (max |h|, |c| error,
    atol).  float32: atol 1e-6 (the same ops in float32; the kernel's expf
    and tanhf against PyTorch's).  bf16: the kernel rounds where the twin
    rounds, so the two differ only where a float32 difference flips a
    bf16 rounding of an intermediate: 2 bf16 ulps at the largest input
    magnitude.  ``offset``: s and c_prev start that many elements into
    their buffers (off 16 bytes: the scalar path)."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    s = torch.randn(N * 5 * H + offset, generator=g,
                    device='cuda').to(dtype)[offset:].view(N, 5 * H)
    c = torch.randn(N * H + offset, generator=g,
                    device='cuda').to(dtype)[offset:].view(N, H)
    h1, c1 = ml.maxout_lstm_gates_fused(s, c)
    h2, c2 = ml.maxout_lstm_gates_ref(s, c)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        atol = 1e-6
    else:
        big = max(s.float().abs().max().item(), c.float().abs().max().item())
        atol = 2.0 ** (torch.floor(torch.log2(torch.tensor(big))).item() - 6)
    err = max((h1.float() - h2.float()).abs().max().item(),
              (c1.float() - c2.float()).abs().max().item())
    if not (err <= atol and h1.dtype == c1.dtype == dtype
            and h1.shape == c1.shape == (N, H)):
        raise AssertionError('maxout_lstm_gates %s N=%d H=%d: max err %g > %g'
                             % (dtype, N, H, err, atol))
    return err, atol


def phase_maxout(torch, ml):
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for N in (5120, 1024):
            for H in (512, 1000):
                e, atol = check_maxout(torch, ml, N, H, dtype, seed=N + H)
                if dtype == torch.bfloat16 and N == 5120 and H == 512:
                    err = e
                log('  maxout_lstm_gates %s N=%d H=%d: ok (max err %.3g, '
                    'atol %.3g)' % (dtype, N, H, e, atol))
        check_maxout(torch, ml, 37, 77, dtype, seed=3)
        # the vector path at one row and at the narrowest vector width;
        # the scalar path on inputs off 16 bytes (a view one element in)
        check_maxout(torch, ml, 1, 8, dtype, seed=4)
        check_maxout(torch, ml, 3, 8, dtype, seed=5, offset=1)
        check_maxout(torch, ml, 1000, 512, dtype, seed=6, offset=1)
    log('  maxout_lstm_gates ragged N=37 H=77, N=1 / 3 H=8, inputs off 16 '
        'bytes (N=3 H=8, N=1000 H=512): ok')
    return err


def phase_topk(torch, tk, bt):
    """The top-k kernel against its twin (the stable sort), values and
    indices bit-identical, on every row kind of ``bench_topk.rows`` at the
    beam and greedy widths, k 1 / 2 / 3 / 5 / 8 / 16, then on ragged and
    unaligned rows."""
    for C in bt.WIDTHS:
        for k in (1, 2, 3, 5, 8, 16):
            for kind in bt.KINDS:
                bt.check(tk, bt.rows(1024, C, kind, k, seed=C + k), k,
                         '[1024, %d] %s' % (C, kind))
        log('  topk_lastdim [1024, %d] k 1 / 2 / 3 / 5 / 8 / 16, rows %s: '
            'identical' % (C, ' / '.join(bt.KINDS)))
    # ragged widths, k up to 16, all--inf and all-NEG rows, and rows whose
    # start is not 16-byte aligned (a contiguous view at an odd offset)
    g = torch.Generator(device='cuda').manual_seed(5)
    for B, C, k in ((37, 1001, 16), (37, 1001, 7), (5, 3, 3), (3, 17, 2)):
        flat = torch.randn(B * C + 1, generator=g, device='cuda')
        x = flat[1:].view(B, C)
        x[0] = float('-inf')
        x[-1] = -1e30
        bt.check(tk, x, k, 'ragged [%d, %d]' % (B, C))
        bt.check(tk, torch.randint(-1, 2, (B, C), generator=g,
                                   device='cuda').float(), k,
                 'ragged tied [%d, %d]' % (B, C))
    torch.cuda.synchronize()
    log('  topk_lastdim ragged widths, k up to 16, -inf / NEG rows, '
        'unaligned rows: identical')
    return 0.0


def replay_topk(torch, tk, bt):
    """B6 by CUDA-graph replay at the UpDown beam-5 table's shape
    ([1024, 5 x 9488]): random rows at k 1 / 5 / 16, and the other row
    kinds at k 5 (ascending rows are the threshold's worst case)."""
    C = bt.WIDTHS[0]
    out = {}
    for kind, ks in (('random', (1, 5, 16)), ('ascending', (5,)),
                     ('descending', (5,)), ('plateau', (5,)),
                     ('lanes', (5,))):
        for k in ks:
            x = bt.rows(1024, C, kind, k, seed=11)
            out['%s k %d' % (kind, k)] = graph_ms(
                torch, lambda: tk.topk_lastdim(x, k), 20)
    return out


def time_new_kernels(torch, ml, tk, bt):
    """Kernel vs twin device time at the flagship step shapes: the maxout
    gates at the StackAtt beam-5 step (N = 5120, H = 512, bf16; CUDA-graph
    replay, and the launch loop beside it) and the top-k over the UpDown
    beam-5 candidate table ([1024, 5 x 9488], k 5, float32)."""
    g = torch.Generator(device='cuda').manual_seed(7)
    s = torch.randn(5120, 5 * 512, generator=g, device='cuda').bfloat16()
    c = torch.randn(5120, 512, generator=g, device='cuda').bfloat16()
    x = bt.rows(1024, 5 * 9488, 'random', 5, seed=7)
    fused = lambda: ml.maxout_lstm_gates_fused(s, c)
    plain = lambda: ml.maxout_lstm_gates_ref(s, c)
    loop = (cuda_ms(fused, 200), cuda_ms(plain, 200))
    log('  maxout_lstm_gates, launch loop (host-paced): kernel %.4f ms, '
        'twin %.4f ms' % loop)
    N, H = c.shape
    B, C = x.shape
    out = {'maxout_lstm_gates': (graph_ms(torch, fused, 100),
                                 graph_ms(torch, plain, 100),
                                 # s, c_prev in; h, c out; ~10 ops a unit
                                 bound(2 * (5 * N * H + 3 * N * H),
                                       10 * N * H, PEAK_F32)),
           'topk_lastdim': (cuda_ms(lambda: tk.topk_lastdim(x, 5), 50),
                            cuda_ms(lambda: tk.top_k(x, 5), 20),
                            # float32 rows; values and int64 indices out
                            bound(4 * B * C + 12 * B * 5, B * C, PEAK_F32))}
    # the library call computing the same function, timed, never used
    library = {'topk_lastdim': cuda_ms(lambda: torch.topk(x, 5), 50)}
    return out, library


# ---------------------------------------------------------------------------
# phase 8: the strided attend of csrc/attend.cu behind attend_merged,
# mha_step_fused and anc_attend, and the bench entry points that run them
# ---------------------------------------------------------------------------

def _rnd(torch, g, dtype):
    return lambda *shape: torch.randn(*shape, generator=g,
                                      device='cuda').to(dtype)


def ulp_tol(torch, out):
    """One bf16 ulp at the largest |out|: a bf16 result rounded once from a
    float32 value lies within half of it."""
    return 2.0 ** (torch.floor(torch.log2(out.float().abs().max())).item()
                   - 7)


def check_attend_merged(torch, ba, N, T, D, h, bw, t0, dtype, seed):
    """Kernel vs twin; the caches must come back untouched.  Tolerance:
    ``bench_beam_attend.tolerance`` (float32 1e-5, bf16 0.05)."""
    from captioning_tpu_torch.tools.bench_beam_attend import tolerance
    g = torch.Generator(device='cuda').manual_seed(seed)
    rnd = _rnd(torch, g, dtype)
    q, k, v = rnd(N, D), rnd(N, T, D), rnd(N, T, D)
    anc = (torch.randint(0, bw, (N, T), generator=g, device='cuda',
                         dtype=torch.int32) if bw > 1 else None)
    k0, v0 = k.clone(), v.clone()
    got = ba.attend_merged(q, k, v, anc, t0, bw=bw, h=h)
    want = ba.attend_merged_ref(q, k, v, anc, t0, bw=bw, h=h)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not (err <= tolerance(dtype) and torch.equal(k, k0)
            and torch.equal(v, v0) and got.dtype == dtype):
        raise AssertionError('attend_merged %s N=%d T=%d D=%d bw=%d t0=%d: '
                             'max err %g > %g or a cache changed'
                             % (dtype, N, T, D, bw, t0, err,
                                tolerance(dtype)))
    return err


def check_mha_step(torch, ms, N, h, T, dk, t, dtype, seed):
    """Kernel vs twin; the caches written in place, bit-identical to the
    twin's and returned as the same tensors.  float32 atol 1e-5.  bf16:
    ``bench_beam_attend.mha_tolerance`` (0.1) against the bf16 twin, and one
    bf16 ulp of max |out| against the float32 twin of the same values (the
    kernel computes in float32 as the Pallas body does and rounds only its
    output)."""
    from captioning_tpu_torch.tools.bench_beam_attend import mha_tolerance
    g = torch.Generator(device='cuda').manual_seed(seed)
    rnd = _rnd(torch, g, dtype)
    q, kn, vn = rnd(N, h, dk), rnd(N, h, dk), rnd(N, h, dk)
    kc, vc = rnd(N, h, T, dk), rnd(N, h, T, dk)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got, ko, vo = ms.mha_step_fused(q, kn, vn, k1, v1, t)
    want = ms.mha_step_ref(q, kn, vn, k2, v2, t)[0]
    torch.cuda.synchronize()
    what = 'mha_step_fused %s N=%d h=%d T=%d dk=%d t=%d' % (dtype, N, h, T,
                                                          dk, t)
    if not (ko is k1 and vo is v1 and torch.equal(k1, k2)
            and torch.equal(v1, v2)):
        raise AssertionError('%s: the written caches differ' % what)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= mha_tolerance(dtype):
        raise AssertionError('%s: max err %g > %g'
                             % (what, err, mha_tolerance(dtype)))
    if dtype == torch.bfloat16:
        f32 = ms.mha_step_ref(q.float(), kn.float(), vn.float(), kc.float(),
                              vc.float(), t)[0]
        e32 = (got.float() - f32).abs().max().item()
        if not e32 <= ulp_tol(torch, f32):
            raise AssertionError('%s: max err %g vs the float32 twin > %g'
                                 % (what, e32, ulp_tol(torch, f32)))
    return err


def check_anc_attend(torch, an, N, L, h, T, dk, bw, l, t, dtype, seed):
    """Kernel vs twin (slice, then attend).  float32 atol 1e-5.  bf16: 0.1
    against the bf16 twin (``bench_anc_attend.ATOL``), and one bf16 ulp of
    max |out| against the float32 twin of the same values."""
    from captioning_tpu_torch.tools.bench_anc_attend import ATOL
    g = torch.Generator(device='cuda').manual_seed(seed)
    rnd = _rnd(torch, g, dtype)
    K, V, q = rnd(N, L, h, T, dk), rnd(N, L, h, T, dk), rnd(N, h * dk)
    anc = torch.randint(0, bw, (N, T), generator=g, device='cuda',
                        dtype=torch.int32)
    got = an.anc_attend(K, V, q, anc, l, t, bw)
    want = an.anc_attend_ref(K, V, q, anc, l, t, bw)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else ATOL
    err = (got.float() - want.float()).abs().max().item()
    what = 'anc_attend %s N=%d L=%d T=%d dk=%d bw=%d l=%d t=%d' % (
        dtype, N, L, T, dk, bw, l, t)
    if not (err <= atol and got.dtype == dtype):
        raise AssertionError('%s: max err %g > %g' % (what, err, atol))
    if dtype == torch.bfloat16:
        f32 = an.anc_attend_ref(K[:, l:l + 1].float(), V[:, l:l + 1].float(),
                                q.float(), anc, 0, t, bw)
        e32 = (got.float() - f32).abs().max().item()
        if not e32 <= ulp_tol(torch, f32):
            raise AssertionError('%s: max err %g vs the float32 twin > %g'
                                 % (what, e32, ulp_tol(torch, f32)))
    return err


def phase_attend(torch, ba, ms, an):
    """The three entry points at the benches' shapes (N 5120 = 1024 images
    x beam 5, 8 heads, dk 64, T 21) in float32 and bf16, and at ragged ones:
    odd N, T 13 and 21, dk 32 and 96, bw 1 / 2 / 5, t first / mid / last,
    l first / last; and at the redesign's edges (see the loop).  Returns the
    bf16 errors at the benches' shapes."""
    errs = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for bw in (5, 1):
            for t0 in (0, 12, 20):
                e = check_attend_merged(torch, ba, 5120, 21, 512, 8, bw, t0,
                                        dtype, seed=bw * 100 + t0)
                if dtype == bf16 and bw == 5 and t0 == 12:
                    errs['attend_merged'] = e
        for t in (0, 12, 20):
            e = check_mha_step(torch, ms, 5120, 8, 21, 64, t, dtype, seed=t)
            if dtype == bf16 and t == 12:
                errs['mha_step_fused'] = e
        for l, t in ((0, 19), (3, 19), (5, 19), (5, 0), (0, 20)):
            e = check_anc_attend(torch, an, 5120, 6, 8, 21, 64, 5, l, t,
                                 dtype, seed=l * 100 + t)
            if dtype == bf16 and (l, t) == (3, 19):
                errs['anc_attend'] = e
        log('  attend_merged / mha_step_fused / anc_attend %s at the bench '
            'shapes: ok' % dtype)
        for T in (13, 21):
            for dk in (32, 96):
                for t in (0, T // 2, T - 1):
                    for bw, N in ((1, 37), (2, 38), (5, 35)):
                        check_attend_merged(torch, ba, N, T, 3 * dk, 3, bw,
                                            t, dtype, seed=T + dk + t + bw)
                        for l in (0, 2):
                            check_anc_attend(torch, an, N, 3, 3, T, dk, bw,
                                             l, t, dtype, seed=T + dk + l)
                    check_mha_step(torch, ms, 37, 3, T, dk, t, dtype,
                                   seed=T + dk + t)
        log('  attend_merged / mha_step_fused / anc_attend %s ragged (odd N, '
            'T 13 / 21, dk 32 / 96, bw 1 / 2 / 5, t first / mid / last, l '
            'first / last): ok' % dtype)
        # the redesign's edges: t on both sides of the 32-step ancestry
        # window, T 70; head widths on 16-, 8- and 4-byte vectors, one lane
        # a head (dk 8 in bf16), several vectors a lane and several warps a
        # row (dk 254 / 256); bw 8, odd N
        for T, t in ((48, 31), (48, 32), (48, 47), (70, 40), (70, 69)):
            for dk in (8, 10, 64, 254, 256):
                for bw, N in ((1, 37), (5, 35), (8, 40)):
                    check_attend_merged(torch, ba, N, T, 3 * dk, 3, bw, t,
                                        dtype, seed=T + dk + t + bw)
                    check_anc_attend(torch, an, N, 3, 3, T, dk, bw, 2, t,
                                     dtype, seed=T + dk + t + bw)
                check_mha_step(torch, ms, 37, 3, T, dk, t, dtype,
                               seed=T + dk + t)
        check_attend_merged(torch, ba, 5120, 48, 512, 8, 5, 47, dtype, seed=1)
        check_mha_step(torch, ms, 5120, 8, 48, 64, 47, dtype, seed=1)
        check_anc_attend(torch, an, 5120, 2, 8, 48, 64, 5, 1, 47, dtype,
                         seed=1)
        log('  attend_merged / mha_step_fused / anc_attend %s stress (T 48 '
            't 31 / 32 / 47, T 70 t 40 / 69, dk 8 / 10 / 64 / 254 / 256, bw '
            '1 / 5 / 8, odd N; N 5120 at T 48 t 47): ok' % dtype)
    return errs


def time_attend(torch, ba, ms, an):
    """Kernel vs twin device time at the benches' shapes, bf16, with the
    bound of each call's inputs; and the library's attention: for
    attend_merged over its caches, for mha_step_fused over the cache it
    wrote (attend only)."""
    g = torch.Generator(device='cuda').manual_seed(7)
    rnd = _rnd(torch, g, torch.bfloat16)
    N, h, dk, T, bw = 5120, 8, 64, 21, 5
    D = h * dk
    out = {}
    t0 = 12
    q, k, v = rnd(N, D), rnd(N, T, D), rnd(N, T, D)
    anc = torch.randint(0, bw, (N, T), generator=g, device='cuda',
                        dtype=torch.int32)
    # q and ctx, anc[:, :t0 + 1], the ancestors' entries j <= t0
    nbytes = (2 * (2 * N * D + 2 * distinct_entries(torch, anc, bw, t0 + 1)
                   * D) + 4 * N * (t0 + 1))
    out['attend_merged'] = (
        cuda_ms(lambda: ba.attend_merged(q, k, v, anc, t0, bw=bw, h=h), 50),
        cuda_ms(lambda: ba.attend_merged_ref(q, k, v, anc, t0, bw=bw, h=h),
                20),
        bound(nbytes, 4 * N * D * (t0 + 1), PEAK_F32))
    library = {'attend_merged': library_ancestry(
        torch, q, k, v, anc, t0, bw, h,
        ba.attend_merged(q, k, v, anc, t0, bw=bw, h=h), 'attend_merged')}
    t = 12
    qh, kn, vn = rnd(N, h, dk), rnd(N, h, dk), rnd(N, h, dk)
    kc, vc = rnd(N, h, T, dk), rnd(N, h, T, dk)
    # q, k_new, v_new; the entries j < t; out and the written entries
    nbytes = 2 * (3 * N * D + 2 * N * h * t * dk + 3 * N * D)
    out['mha_step_fused'] = (
        cuda_ms(lambda: ms.mha_step_fused(qh, kn, vn, kc, vc, t), 50),
        cuda_ms(lambda: ms.mha_step_ref(qh, kn, vn, kc, vc, t), 20),
        bound(nbytes, 4 * N * D * (t + 1), PEAK_F32))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = qh[:, :, None]
    library['mha_step_fused'] = cuda_ms(
        lambda: sdpa(q4, kc[:, :, :t + 1], vc[:, :, :t + 1]), 50)
    L, l, t = 6, 3, 19
    K, V = rnd(N, L, h, T, dk), rnd(N, L, h, T, dk)
    nbytes = (2 * (2 * N * D + 2 * distinct_entries(torch, anc, bw, t + 1)
                   * D) + 4 * N * (t + 1))
    out['anc_attend'] = (
        cuda_ms(lambda: an.anc_attend(K, V, q, anc, l, t, bw), 50),
        cuda_ms(lambda: an.anc_attend_ref(K, V, q, anc, l, t, bw), 20),
        bound(nbytes, 4 * N * D * (t + 1), PEAK_F32))
    # the same three calls by graph replay (the host taken out)
    replay = {
        'attend_merged t0 12': graph_ms(
            torch, lambda: ba.attend_merged(q, k, v, anc, t0, bw=bw, h=h),
            20),
        'mha_step_fused t 12': graph_ms(
            torch, lambda: ms.mha_step_fused(qh, kn, vn, kc, vc, 12), 20),
        'anc_attend l 3 t 19': graph_ms(
            torch, lambda: an.anc_attend(K, V, q, anc, l, t, bw), 20)}
    return out, library, replay


def phase_benches(torch, wrappers):
    """Both bench entry points at full size, with every wrapper's launch
    counter set to 0 just before and each kernel they run required to have
    grown just after; returns the counts."""
    from captioning_tpu_torch.tools import bench_anc_attend, bench_beam_attend
    for fn in wrappers.values():
        fn.launches = 0
    bench_beam_attend.main(['--iters', '5'])
    bench_anc_attend.main(['5120', '21', '5'])
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name in ('attend_merged', 'mha_step_fused', 'anc_attend',
                 'attend_write_merged'):
        if counts[name] <= 0:
            raise AssertionError('%s was never launched by the benches'
                                 % name)
    log('  bench launches: %s' % counts)
    return counts


# ---------------------------------------------------------------------------
# phase 9: XE training through the port's Trainer
# ---------------------------------------------------------------------------

def train_agreement(torch, model):
    """One xe_step on the card and on the CPU from one init and batch,
    dropout 0, no clip: (loss rel err, worst gradient err over its
    tensor's largest magnitude)."""
    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.tools import profile_train as pt
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('TF32 matmuls are on: the f32 agreement needs '
                             'them off')
    batch = pt.train_batch(2, seed=3)
    got = {}
    for device in ('cuda', 'cpu'):
        cap = pt.train_captioner(model, device, drop_prob_lm=0.0,
                                 dropout=0.0)
        tr = Trainer(cap, pt.train_opt(grad_clip_value=0.0))
        fc, att, am, labels, masks = (x.to(device) for x in batch)
        loss = tr.xe_step(fc, att, labels, masks, am, 5e-4, 0.0,
                          torch.Generator(device).manual_seed(0))['loss']
        got[device] = (float(loss), {n: p.grad.detach().cpu().clone()
                                     for n, p in tr.named_params.items()})
        del cap, tr
    (lg, gg), (lc, gc) = got['cuda'], got['cpu']
    return step_agreement(model, 'xe_step', lg, lc, gg, gc)


def step_agreement(model, what, lg, lc, gg, gc):
    """A train step's loss on the card (lg) against the CPU's (lc) within
    1e-5 relative, and each gradient of ``gg`` against ``gc`` within 1e-4
    of its tensor's largest magnitude: (loss rel err, worst gradient
    err)."""
    loss_err = abs(lg - lc) / max(abs(lc), 1e-30)
    # a bias added to every score of a softmax row (alpha_net's, the
    # attention K projections') has an exact gradient of 0: on both
    # devices it is rounding, held to 1e-6 of the model's largest gradient
    scale = max(float(g.abs().max()) for g in gc.values())
    if not scale > 0:
        raise AssertionError('%s %s: every gradient is 0 on the CPU'
                             % (model, what))
    zero = sorted(n for n in gc if float(gc[n].abs().max()) <= 1e-6 * scale)
    zero_err = max([float(gg[n].abs().max()) / scale for n in zero],
                   default=0.0)
    errs = {n: float((gg[n] - gc[n]).abs().max()) / float(gc[n].abs().max())
            for n in gc if n not in zero}
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    log('  %s f32 %s, kernels (card) vs twins (CPU): loss %.6f vs '
        '%.6f (rel %.2e); worst gradient err / its tensor max %.2e (%s) over '
        '%d tensors; %d zero up to rounding (%s) at most %.2e of the '
        'largest gradient on the card'
        % (model, what, lg, lc, loss_err, grad_err, worst, len(errs),
           len(zero), ', '.join(zero), zero_err))
    if not (loss_err <= 1e-5 and grad_err <= 1e-4 and zero_err <= 1e-6):
        raise AssertionError('%s f32 %s: loss rel err %.2e (max '
                             '1e-5), gradient err %.2e (max 1e-4, %s), zero '
                             'gradients %.2e (max 1e-6)'
                             % (model, what, loss_err, grad_err, worst,
                                zero_err))
    return loss_err, grad_err


def train_run(torch, model, wrappers, per_step, warm=2, steps=10):
    """``warm`` + ``steps`` XE steps of ``model`` with its config's
    options (``profile_train.TRAIN``) at batch 10 x 5, L 16 on one seeded
    batch; the launch counters are set to 0 after the warm-up and each
    wrapper must then count ``per_step[name]`` launches a step (0 for the
    others).  The last step restores the generator state of the first
    measured one, so the two losses see the same dropout and sampling
    draws.  Returns the run's record."""
    from captioning_tpu_torch.tools import profile_train as pt
    torch.cuda.empty_cache()
    tr, step, gen = pt.make_step(model)       # step(iteration), 1-based
    for it in range(1, warm + 1):
        step(it)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first_state = gen.get_state()
    losses, dev_ms, wall_ms = [], [], []
    for it in range(warm + 1, warm + steps + 1):
        if it == warm + steps:
            gen.set_state(first_state)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.time()
        start.record()
        loss = step(it)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append(1000 * (time.time() - t))
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, n in counts.items():
        want = per_step.get(name, 0) * steps
        if n != want:
            raise AssertionError('%s training: %s launched %d times in %d '
                                 'steps, expected %d' % (model, name, n,
                                                         steps, want))
    if not all(v == v and abs(v) != float('inf') for v in losses):
        raise AssertionError('%s training: a loss is not finite: %s'
                             % (model, losses))
    if not losses[-1] < losses[0]:
        raise AssertionError('%s training: the last loss %.6f is not below '
                             'the first %.6f' % (model, losses[-1],
                                                 losses[0]))

    def spread(v):
        v = sorted(v)
        return v[len(v) // 2], v[0], v[-1]

    rec = {'model': model, 'steps': steps, 'loss_first': losses[0],
           'loss_last': losses[-1], 'step_ms_events': spread(dev_ms),
           'step_ms_wall': spread(wall_ms), 'peak_gib': peak,
           'launches_per_step': {n: c // steps for n, c in counts.items()
                                 if c}}
    log('  %s train step (batch 10 x 5, L 16): median %.2f ms by CUDA '
        'events (min %.2f, max %.2f), host wall median %.2f ms (min %.2f, '
        'max %.2f); peak memory %.3f GiB; loss %.4f -> %.4f over %d steps '
        '(same draws); launches a step %s'
        % ((model,) + rec['step_ms_events'] + rec['step_ms_wall']
           + (peak, losses[0], losses[-1], steps,
              rec['launches_per_step'])))
    del tr
    return rec, counts


def phase_train(torch, wrappers):
    """Phase 9; returns the launch counts of the training runs."""
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for model in ('updown', 'stackatt', 'newfc', 'transformer'):
        train_agreement(torch, model)
    # B3 once a head and B5 once a maxout cell, each time step (17)
    runs = [('updown', {'additive_attention': 17}),
            ('stackatt', {'additive_attention': 34,
                          'maxout_lstm_gates': 51}),
            ('transformer', {})]
    launches = dict.fromkeys(wrappers, 0)
    records = []
    for model, per_step in runs:
        rec, counts = train_run(torch, model, wrappers, per_step)
        records.append(rec)
        for name, n in counts.items():
            launches[name] += n
    log('  training record: %s' % json.dumps(records))
    return launches


# ---------------------------------------------------------------------------
# phase 11: SCST and structure training through the port's Trainer
# ---------------------------------------------------------------------------

def rl_agreement(torch, model, scorers):
    """One sc_fused_step and one struc_fused_step (new_self_critical) of
    ``model`` at full width, 2 images x 5 samples, dropout 0, on the card
    (kernels) and on the CPU (twins), the sampling noise drawn once on the
    CPU and fed to both, at learning rate 0 so both steps read the init:
    the greedy and sampled sequences of ``sc_decode`` identical, the
    rewards within 1e-5, each step's loss and gradients as
    ``step_agreement`` holds them."""
    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.tools import profile_train as pt
    got = {}
    for device in ('cuda', 'cpu'):
        cap = pt.train_captioner(model, device, drop_prob_lm=0.0,
                                 dropout=0.0)
        tr = Trainer(cap, pt.rl_opt(grad_clip_value=0.0))
        fc, att, am, labels, masks, refs, ref_mask = pt.rl_batch(cap, 2, 3)
        scorer, gen = scorers[device], torch.Generator(device).manual_seed(0)
        greedy, sampled = tr.sc_decode(fc, att, am, None,
                                       cpu_draws(torch, 200), gen)
        # the second reference of each image is its first sample, which
        # both steps below draw again: a random model's samples share no
        # n-gram with other references, and all-equal scores would leave
        # the structure loss's leave-one-out advantage at 0
        refs[:, 1, :-1] = sampled[::5, :refs.shape[2] - 1]
        refs[:, 1, -1] = 0
        rec = {'greedy': greedy.cpu(), 'sampled': sampled.cpu(),
               'reward': scorer.self_critical_reward(
                   greedy, sampled, refs, ref_mask).cpu()}
        out = tr.sc_fused_step(fc, att, am, refs, ref_mask, 0.0, None,
                               cpu_draws(torch, 200), gen, scorer)
        # copies: the trainer's gradient buffers are reused by its next
        # step (on the CPU ``.cpu()`` would return the buffer itself)
        rec['scst'] = (float(out['loss']), {
            n: p.grad.detach().cpu().clone()
            for n, p in tr.named_params.items()})
        rec['scst_reward'] = float(out['reward'])
        out = tr.struc_fused_step(fc, att, labels, masks, am, refs,
                                  ref_mask, 0.0, cpu_draws(torch, 200), gen,
                                  gen, scorer)
        rec['struc'] = (float(out['loss']), {
            n: p.grad.detach().cpu().clone()
            for n, p in tr.named_params.items()})
        rec['struc_reward'] = out['reward'].cpu()
        got[device] = rec
        del cap, tr
    g, c = got['cuda'], got['cpu']
    for key in ('greedy', 'sampled'):
        if not torch.equal(g[key], c[key]):
            raise AssertionError('%s f32 sc_decode: the %s sequences differ '
                                 'on %d of %d rows' % (
                                     model, key,
                                     int((g[key] != c[key]).any(1).sum()),
                                     g[key].shape[0]))
    reward_err = max(float((g['reward'] - c['reward']).abs().max()),
                     abs(g['scst_reward'] - c['scst_reward']),
                     float((g['struc_reward'] - c['struc_reward'])
                           .abs().max()))
    log('  %s f32 sc_decode: greedy and sampled sequences identical '
        '(%d + %d rows, longest %d tokens); rewards card vs CPU max diff '
        '%.2e (mean advantage %.6f vs %.6f)'
        % (model, g['greedy'].shape[0], g['sampled'].shape[0],
           int((g['sampled'] > 0).sum(1).max()), reward_err,
           g['scst_reward'], c['scst_reward']))
    if not reward_err <= 1e-5:
        raise AssertionError('%s f32 rewards: card vs CPU %.2e (max 1e-5)'
                             % (model, reward_err))
    return {what: step_agreement(model, name, g[what][0], c[what][0],
                                 g[what][1], c[what][1])
            for what, name in (('scst', 'sc_fused_step'),
                               ('struc', 'struc_fused_step'))}


def rl_run(torch, model, B, scorer, df_path, wrappers, check_launches,
           warm=1, steps=4):
    """``warm`` + ``steps`` fused SCST steps of ``model`` with its SCST
    stage's options (``profile_train.RL``) at B images x 5 samples, decode
    length 20, on one seeded batch; the launch counters are set to 0 after
    the warm-up and ``check_launches(counts a step)`` holds them.  Then one
    ``sc_decode`` is scored on the card and by the python CiderD on the
    CPU (``utils/rewards.py``), within 1e-4.  Returns the run's record and
    its launch counts."""
    from captioning_tpu_torch.tools import profile_train as pt
    from captioning_tpu_torch.utils import rewards
    torch.cuda.empty_cache()
    tr, step, (gen, noise), (fc, att, am, refs, ref_mask) = pt.make_rl_step(
        model, 'scst', 'cuda', B, scorer=scorer)
    for it in range(warm):
        step(it)
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    dev_ms, wall_ms, losses, rewards_run = [], [], [], []
    for it in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.time()
        start.record()
        out = step(it)
        end.record()
        torch.cuda.synchronize()
        wall_ms.append(1000 * (time.time() - t))
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(out['loss']))
        rewards_run.append(float(out['reward']))
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {n: c / steps for n, c in counts.items() if c}
    check_launches(per_step)
    if not all(v == v and abs(v) != float('inf')
               for v in losses + rewards_run):
        raise AssertionError('%s SCST: a loss or reward is not finite'
                             % model)

    rewards.init_scorer(df_path)
    greedy, sampled = tr.sc_decode(fc, att, am, noise, noise, gen)
    card = scorer.self_critical_reward(greedy, sampled, refs, ref_mask).cpu()
    n_refs = ref_mask.sum(1).long().tolist()
    gts = [r[:k] for r, k in zip(refs.cpu().numpy(), n_refs)]
    host = torch.from_numpy(rewards.get_self_critical_reward(
        greedy.cpu().numpy(), gts, sampled.cpu().numpy(), tr.opt))
    reward_err = float((card - host).abs().max())
    if not reward_err <= 1e-4:
        raise AssertionError('%s SCST reward: card vs the python CiderD on '
                             'the CPU %.2e (max 1e-4)' % (model, reward_err))

    def spread(v):
        v = sorted(v)
        return v[len(v) // 2] / 1000, v[0] / 1000, v[-1] / 1000

    rec = {'model': model, 'batch': '%d x 5' % B, 'steps': steps,
           's_iter_events': spread(dev_ms), 's_iter_wall': spread(wall_ms),
           'peak_gib': peak, 'reward_mean_run': sum(rewards_run) / steps,
           'reward_card': float(card[:, 0].mean()),
           'reward_host': float(host[:, 0].mean()),
           'reward_max_diff': reward_err, 'launches_per_step': per_step}
    log('  %s SCST fused step (batch %d x 5, decode length 20): median '
        '%.4f s/iter by CUDA events (min %.4f, max %.4f), host wall median '
        '%.4f s (min %.4f, max %.4f); peak memory %.3f GiB; mean reward '
        '%.6f over the run; an sc_decode scored on the card %.6f and by the '
        'python CiderD on the CPU %.6f (max diff %.2e); launches a step %s'
        % ((model, B) + rec['s_iter_events'] + rec['s_iter_wall']
           + (peak, rec['reward_mean_run'], rec['reward_card'],
              rec['reward_host'], reward_err, per_step)))
    del tr
    return rec, counts


def phase_rl(torch, wrappers):
    """Phase 11; returns the launch counts of the timed SCST runs."""
    import pickle

    from captioning_tpu_torch.ops.cider_device import DeviceCiderD
    from captioning_tpu_torch.tools import profile_train as pt
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t = time.time()
    df, ref_len = pt.corpus_df()
    df_path = os.path.join(HERE, 'build', 'phase11-idxs.p')
    os.makedirs(os.path.dirname(df_path), exist_ok=True)
    with open(df_path, 'wb') as f:
        pickle.dump({'document_frequency': df, 'ref_len': ref_len}, f)
    scorers = {d: DeviceCiderD(df, ref_len, device=d)
               for d in ('cuda', 'cpu')}
    log('  df table: %d n-grams over %d images x %d references (%.1f s)'
        % (len(df), ref_len, pt.CORPUS_REFS, time.time() - t))
    for model in ('updown', 'transformer'):
        rl_agreement(torch, model, scorers)

    def updown(per_step):
        # B3 on each baseline step (at least one) and on each of the
        # sampling pass's 20
        if per_step.get('additive_attention', 0) < 21 or set(per_step) != {
                'additive_attention'}:
            raise AssertionError('UpDown SCST launches a step %s: B3 at '
                                 'least 21, no other kernel' % per_step)

    def transformer(per_step):
        # the greedy baseline's uniform steps: B2's k = 1 epilogue once and
        # B1 once a layer a step; the train-mode sampling runs the plain
        # per-row step
        b2 = per_step.get('logit_topk', 0)
        if b2 < 1 or per_step.get('attend_write_merged') != 6 * b2 or set(
                per_step) != {'logit_topk', 'attend_write_merged'}:
            raise AssertionError('transformer SCST launches a step %s: B2 at '
                                 'least once, B1 six times as often, no '
                                 'other kernel' % per_step)

    launches = dict.fromkeys(wrappers, 0)
    records = []
    for model, B, check in (('updown', 10, updown),
                            ('transformer', 10, transformer),
                            ('transformer', 50, transformer)):
        rec, counts = rl_run(torch, model, B, scorers['cuda'], df_path,
                             wrappers, check)
        records.append(rec)
        for name, n in counts.items():
            launches[name] += n
    log('  SCST record: %s' % json.dumps(records))
    return launches, scorers['cuda']


# ---------------------------------------------------------------------------
# phases 4-7 and 10: the models' decodes through Captioner
# ---------------------------------------------------------------------------

def check_output(torch, seq, stats, B, L, V, nan_entropy=False):
    if tuple(seq.shape) != (B, L) or int(seq.min()) < 0 or int(
            seq.max()) > V:
        raise AssertionError('decode output: shape %s range [%d, %d]'
                             % (tuple(seq.shape), int(seq.min()),
                                int(seq.max())))
    for key in ('lp_sum',) if nan_entropy else ('ent_sum', 'lp_sum'):
        if not bool(torch.isfinite(stats[key]).all()):
            raise AssertionError('decode output: %s not finite' % key)
    if not bool((stats['lp_sum'] <= 0).all()):
        raise AssertionError('decode output: positive logprob sum')


# phase 10: model -> [(a mode of profile_decode.MODES, the kernels its
# path runs)]
PHASE10 = {
    'transformer': [('general5', ['attend_write_merged', 'topk_lastdim']),
                    ('dbs6g3', ['topk_lastdim']),
                    ('sample5', ['attend_write_merged']),
                    ('top3x5', ['attend_write_merged']),
                    ('top0.9x5', ['attend_write_merged']),
                    ('gumbel5', ['attend_write_merged']),
                    ('replay5', ['attend_write_merged', 'logit_topk'])],
    'updown': [('dbs6g3', ['additive_attention', 'topk_lastdim']),
               ('sample5', ['additive_attention'])],
    'newfc': [('dbs6g3', ['maxout_lstm_gates', 'topk_lastdim']),
              ('dgreedy5', ['maxout_lstm_gates'])],
}


def cpu_draws(torch, seed):
    """One noise for both devices: ``draw(kind, t, shape)`` made on the
    CPU from a seeded generator the first time a key is asked for, the
    same tensor after (the engine moves it to the decode's device)."""
    from captioning_tpu_torch.engine.decoding import generator_draw
    base, cache = generator_draw(torch.Generator().manual_seed(seed)), {}

    def draw(kind, t, shape):
        key = (kind, t, tuple(shape))
        if key not in cache:
            cache[key] = base(kind, t, shape)
        return cache[key]
    return draw


def phase_decode(torch, model, modes, wrappers, batches=3, tables=None,
                 table_mode='beam5'):
    """Each mode of ``modes`` ([(a mode of profile_decode.MODES, required
    kernels)]) at B = 1024, bf16, through ``Captioner``, with every
    wrapper's launch counter set to 0 just before it and each required
    kernel's grown just after; its cap/s (captions returned: 5 an image for
    sample_n 5 and the 5 diverse groups).  With ``tables`` (a list), one
    more ``table_mode`` batch after the counts are read appends the
    candidate table of its middle step.  Then each mode's f32 agreement of
    the kernels (CUDA) with the twins (CPU) at B = 8, the sampling noise
    drawn once on the CPU and fed to both."""
    from captioning_tpu_torch.tools import bench_topk as bt
    from captioning_tpu_torch.tools import profile_decode as pd
    torch.cuda.empty_cache()
    cap = pd.make_captioner(model, 'bfloat16', 'cuda')
    B, L = 1024, 20
    fc, att, am = pd.features(B, 'cuda', seed=1)
    rates, launches = {}, dict.fromkeys(wrappers, 0)
    for mode, required in modes:
        rows = B * pd.MODES[mode][2]
        for fn in wrappers.values():
            fn.launches = 0
        ms = []
        for i in range(batches + 1):          # a warm-up, then timed ones
            t = time.time()
            seq, stats = pd.decode(cap, mode, fc, att, am)
            torch.cuda.synchronize()
            if i:
                ms.append(1000 * (time.time() - t))
            # the constrained general body's entropy is NaN where a step's
            # row holds -inf (0 * -inf), as in the JAX engine
            check_output(torch, seq, stats, rows, L, pd.V,
                         nan_entropy=mode == 'general5')
        counts = {name: fn.launches for name, fn in wrappers.items()}
        for name in required:
            if counts[name] <= 0:
                raise AssertionError('%s was never launched on the %s %s '
                                     'path' % (name, model, mode))
        for name, n in counts.items():
            launches[name] += n
        rates[mode] = rows / (sorted(ms)[batches // 2] / 1000)
        log('  cap/s %s %s: %.1f' % (model, mode, rates[mode]))
        log('  %s %s B=%d (%d captions): ms per batch %s; longest caption '
            '%d steps; launches %s (a batch: %s)'
            % (model, mode, B, rows, ', '.join('%.1f' % v for v in ms),
               int((seq > 0).sum(1).max()) + 1, counts,
               {n: c // (batches + 1) for n, c in counts.items() if c}))
        del seq, stats
    if tables is not None:
        tables.append(bt.capture_table(cap, fc, att, am, mode=table_mode))
    del cap
    torch.cuda.empty_cache()

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    agree = {}
    capg = pd.make_captioner(model, 'float32', 'cuda')
    capc = pd.make_captioner(model, 'float32', 'cpu')
    fc, att, am = pd.features(8, 'cpu', seed=2)
    for i, (mode, _) in enumerate(modes):
        draw = cpu_draws(torch, 100 + i)
        sg, stg = pd.decode(capg, mode, fc.cuda(), att.cuda(), am.cuda(),
                            draw)
        sc, stc = pd.decode(capc, mode, fc, att, am, draw)
        same = (sg.cpu() == sc).all(1).float().mean().item()
        err = (stg['lp_sum'].cpu() - stc['lp_sum']).abs().max().item()
        agree[mode] = same
        log('  %s f32 %s: captions identical kernels vs twins %.3f, max '
            'lp_sum diff %.2e' % (model, mode, same, err))
        if same < 0.75:
            raise AssertionError('f32 %s %s: kernels and twins agree on only '
                                 '%.3f of the captions' % (model, mode, same))
    return rates, launches, agree


# ---------------------------------------------------------------------------
# phase 12: the CUDA-graph decodes against the eager ones, and the bench
# ---------------------------------------------------------------------------

# model -> (kernels its graphs must hold in both modes, in beam only), by
# the wrappers' names in chip_smoke's ``wrappers``
PHASE12 = {'transformer': (['attend_write_merged', 'logit_topk'], []),
           'updown': (['additive_attention'], ['topk_lastdim']),
           'stackatt': (['additive_attention', 'maxout_lstm_gates'],
                        ['topk_lastdim']),
           'newfc': (['maxout_lstm_gates'], ['topk_lastdim'])}


def timed(torch, fn):
    """(fn's result, host wall ms, CUDA-event ms) of one call ending in a
    synchronize."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.time()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, 1000 * (time.time() - t), start.elapsed_time(end)


def first_gaps(torch, cap, fc, att, am, seq_a, seq_b, rows=3):
    """For up to ``rows`` rows where two decodes' tokens differ: at the
    first step they differ, the teacher-forced log-probs (over ``seq_a``'s
    prefix) of both tokens and the gap between the step's two best."""
    out = []
    for r in (seq_a != seq_b).any(1).nonzero()[:rows, 0].tolist():
        t = int((seq_a[r] != seq_b[r]).nonzero()[0, 0])
        inp = torch.cat([torch.zeros_like(seq_a[r:r + 1, :1]),
                         seq_a[r:r + 1, :-1]], 1)
        lp = cap.forward_tf(fc[r:r + 1], att[r:r + 1], inp, am[r:r + 1])
        top2 = lp[0, t].topk(2).values
        out.append({'row': r, 'step': t,
                    'lp_a': float(lp[0, t, seq_a[r, t]]),
                    'lp_b': float(lp[0, t, seq_b[r, t]]),
                    'top2_gap': float(top2[0] - top2[1])})
    return out


def phase_graphs(torch, wrappers):
    """The four models, beam 5 and greedy at B = 1024, bf16, through the
    graph entries (``sample_beam_graphed`` / ``sample_stats_graphed``) and
    the eager ones: the capture time and memory, the kernels each entry's
    graphs hold (PHASE12's required), no wrapper launch on a graph batch
    (its kernels run in its graphs), 3 walls a route in turns (eager,
    graph, graph, eager, eager, graph) with their CUDA-event time, the
    launches the graphs' replays ran (captures x replays), and graph vs
    eager tokens (a difference reported with its top-2 gap); then float32
    graph vs eager tokens, required identical, at B = 8 for the four
    models and at B = 1024 for the transformer.  Returns the record."""
    from captioning_tpu_torch.tools import profile_decode as pd
    short = {fn.__name__: name for name, fn in wrappers.items()}
    record = {}
    for model, (both, beam_only) in PHASE12.items():
        torch.cuda.empty_cache()
        cap = pd.make_captioner(model, 'bfloat16', 'cuda')
        fc, att, am = pd.features(1024, 'cuda', seed=1)
        for mode in ('beam5', 'greedy'):
            required = both + (beam_only if mode == 'beam5' else [])
            t = time.time()
            pd.decode(cap, mode, fc, att, am, graphed=True)
            torch.cuda.synchronize()
            first_s = time.time() - t
            entry = list(cap._graph_cache.values())[-1]
            held = {short.get(k, k): n for k, n in entry.held().items()}
            for name in required:
                if held.get(name, 0) <= 0:
                    raise AssertionError('%s is not among the %s %s graphs\' '
                                         'captures %s' % (name, model, mode,
                                                          held))
            for fn in wrappers.values():
                fn.launches = 0
            before = cap.graph_launches()
            pd.decode(cap, mode, fc, att, am, graphed=True)
            torch.cuda.synchronize()
            eager = {n: fn.launches for n, fn in wrappers.items()
                     if fn.launches}
            if eager:
                raise AssertionError('a %s %s graph batch launched kernels '
                                     'outside its graphs: %s'
                                     % (model, mode, eager))
            pd.decode(cap, mode, fc, att, am)              # eager warm-up
            walls = {False: [], True: []}
            outs = {}
            for graphed in (False, True, True, False, False, True):
                outs[graphed], wall, dev = timed(torch, lambda: pd.decode(
                    cap, mode, fc, att, am, graphed=graphed))
                walls[graphed].append([round(wall, 3), round(dev, 3)])
            replayed = {short.get(k, k): n - before.get(k, 0)
                        for k, n in cap.graph_launches().items()}
            for name in required:
                if replayed.get(name, 0) <= 0:
                    raise AssertionError('the %s %s graphs never ran %s'
                                         % (model, mode, name))
            (sg, stg), (se, ste) = outs[True], outs[False]
            check_output(torch, sg, stg, 1024, 20, pd.V)
            same = (sg == se).all(1).float().mean().item()
            rec = {'capture_s': round(entry.capture_s, 3),
                   'first_call_s': round(first_s, 3),
                   'graphs': len(entry.graphs),
                   'bytes_allocated': entry.bytes_allocated,
                   'bytes_reserved': entry.bytes_reserved,
                   'held': held, 'replay_launches': replayed,
                   'eager_ms_events': walls[False],
                   'graph_ms_events': walls[True],
                   'bf16_tokens_identical': same,
                   'lp_sum_max_diff': (stg['lp_sum'] - ste['lp_sum']).abs()
                   .max().item()}
            if same < 1:
                rec['first_differences'] = first_gaps(torch, cap, fc, att,
                                                      am, se, sg)
            record['%s %s' % (model, mode)] = rec
            log('  %s %s B=1024 bf16: capture %.2f s (%d graphs, %.1f MiB '
                'allocated, %.1f MiB reserved), walls [host ms, event ms] '
                'eager %s, graph %s; graph tokens identical to eager %.4f; '
                'replays ran %s' % (model, mode, entry.capture_s,
                                    len(entry.graphs),
                                    entry.bytes_allocated / 2 ** 20,
                                    entry.bytes_reserved / 2 ** 20,
                                    walls[False], walls[True], same,
                                    replayed))
            if same < 1:
                log('  %s %s bf16 differences: %s'
                    % (model, mode, json.dumps(rec['first_differences'])))
        del cap
    torch.cuda.empty_cache()
    for model in PHASE12:
        capf = pd.make_captioner(model, 'float32', 'cuda')
        for B in (8, 1024) if model == 'transformer' else (8,):
            fc, att, am = pd.features(B, 'cuda', seed=2)
            for mode in ('beam5', 'greedy'):
                sg, stg = pd.decode(capf, mode, fc, att, am, graphed=True)
                se, ste = pd.decode(capf, mode, fc, att, am)
                same = (sg == se).all(1).float().mean().item()
                err = (stg['lp_sum'] - ste['lp_sum']).abs().max().item()
                record['%s %s f32 B=%d' % (model, mode, B)] = {
                    'tokens_identical': same, 'lp_sum_max_diff': err}
                log('  %s %s f32 B=%d: graph tokens identical to eager %.4f, '
                    'max lp_sum diff %.2e' % (model, mode, B, same, err))
                if same < 1:
                    raise AssertionError('f32 %s %s B=%d: graph and eager '
                                         'tokens differ (%.4f identical)'
                                         % (model, mode, B, same))
        del capf
        torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# phase 13: the CUDA-graph train steps against the eager ones
# ---------------------------------------------------------------------------

# (step kind of profile_train, model, images): XE at 10 x 5, L 16; the
# fused SCST step at 10 x 5 (and the transformer at 50 x 5); the SCST grad
# step (the host-scorer route's gradient half) at 10 x 5
PHASE13 = [('xe', 'updown', 10), ('xe', 'stackatt', 10),
           ('xe', 'transformer', 10), ('scst', 'updown', 10),
           ('scst', 'transformer', 10), ('scst', 'transformer', 50),
           ('scst_grad', 'updown', 10)]
# kernel wrapper -> its launches a step on each path (the greedy baseline
# and the sampling pass run all 20 decode steps; the XE input is 17
# tokens; the recompute runs 20 steps), by the names of ``wrappers``
PHASE13_LAUNCHES = {
    ('xe', 'updown'): {'additive_attention': 17},
    ('xe', 'stackatt'): {'additive_attention': 34, 'maxout_lstm_gates': 51},
    ('xe', 'transformer'): {},
    ('scst', 'updown'): {'additive_attention': 40},
    ('scst', 'transformer'): {'attend_write_merged': 120, 'logit_topk': 20},
    ('scst_grad', 'updown'): {'additive_attention': 20},
    ('xe', 'aoa'): {},
    ('scst', 'aoa'): {},
}


def _step_out(out):
    return out if isinstance(out, dict) else {'loss': out}


def _tensor_err(torch, a, b):
    """max |a - b| over the largest |a| (0 where both are 0)."""
    scale = float(a.abs().max())
    err = float((a.float() - b.float()).abs().max())
    return err / scale if scale > 0 else err


def train_state_err(torch, te, tg):
    """The worst parameter and optimizer-moment difference of two
    trainers, each over its tensor's largest magnitude: (err, its name)."""
    worst, where = 0.0, ''
    for name, pe in te.named_params.items():
        pg = tg.named_params[name]
        pairs = [(name, pe.detach(), pg.detach())]
        se, sg = te.optimizer.state[pe], tg.optimizer.state[pg]
        pairs += [('%s.%s' % (name, k), se[k], sg[k]) for k in se
                  if torch.is_tensor(se[k])]
        for what, a, b in pairs:
            e = _tensor_err(torch, a, b)
            if e > worst:
                worst, where = e, what
    return worst, where


def graph_train_case(torch, kind, model, B, scorer, wrappers):
    """One case of phase 13: an eager and a graphed trainer of ``model``
    from one init, batch and generator seeds.  3 steps each, held against
    each other (sequences identical, loss and reward within 1e-6
    relative, then every parameter and optimizer moment within 1e-5 of
    its tensor's largest magnitude); 20 timed steps a route in turns,
    blocks of 5 (eager, graph, graph, eager, ...), each ending in a
    synchronize (host wall and CUDA events), with each route's peak
    memory over what was allocated before (the graph's temporaries live
    in its pool, whose size is given); one profiled step a route (device
    busy; idle share = 1 - busy / the median wall); no wrapper launch on
    a replay and the graph's launches captures x replays.  Returns
    (record, launches of the replays)."""
    from captioning_tpu_torch.tools import profile_train as pt
    short = {fn.__name__: name for name, fn in wrappers.items()}
    torch.cuda.empty_cache()
    case_start = time.time()
    made = {}
    for graphed in (False, True):
        if kind == 'xe':
            tr, step, gen = pt.make_step(model, 'cuda', B, graphed=graphed)
        else:
            tr, step, _, _ = pt.make_rl_step(model, kind, 'cuda', B, scorer,
                                            graphed=graphed)
        made[graphed] = (tr, step)
    (te, se), (tg, sg) = made[False], made[True]
    what = '%s %s %d x 5' % (kind, model, B)
    loss_err = 0.0
    for it in range(1, 4):
        oe, og = _step_out(se(it)), _step_out(sg(it))
        for key in ('greedy', 'sampled'):
            if key in oe and not torch.equal(oe[key], og[key]):
                raise AssertionError('%s step %d: the %s sequences of the '
                                     'graph and the eager step differ on %d '
                                     'rows' % (what, it, key, int(
                                         (oe[key] != og[key]).any(1).sum())))
        for key in ('loss', 'reward'):
            if key in oe:
                a, b = float(oe[key]), float(og[key])
                e = abs(a - b) / max(abs(a), 1e-30)
                loss_err = max(loss_err, e)
                if not e <= 1e-6:
                    raise AssertionError('%s step %d: %s eager %.9g, graph '
                                         '%.9g (rel %.2e, max 1e-6)'
                                         % (what, it, key, a, b, e))
    state_err, where = train_state_err(torch, te, tg)
    if not state_err <= 1e-5:
        raise AssertionError('%s: after 3 steps %s differs by %.2e of its '
                             'largest magnitude (max 1e-5)'
                             % (what, where, state_err))
    entry = list(tg._graphs.values())[-1]
    held = {short.get(k, k): n for k, n in entry.held().items()}
    want = PHASE13_LAUNCHES[(kind, model)]
    if held != want:
        raise AssertionError('%s: the graph holds %s, expected %s'
                             % (what, held, want))
    walls = {False: [], True: []}
    events = {False: [], True: []}
    # each route's peak over what was allocated before its steps: the
    # graph's temporaries live in its pool (``bytes_reserved``), so its
    # replays allocate nothing
    peak = {False: 0.0, True: 0.0}
    replays_before = entry.replays
    eager_launches = dict.fromkeys(wrappers, 0)
    it = 4
    for graphed in (False, True, True, False) * 2:
        step = sg if graphed else se
        before = {n: fn.launches for n, fn in wrappers.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(5):
            _, wall, dev = timed(torch, lambda: step(it))
            walls[graphed].append(wall)
            events[graphed].append(dev)
            it += 1
        peak[graphed] = max(peak[graphed], (torch.cuda.max_memory_allocated()
                                            - base) / 2 ** 30)
        delta = {n: fn.launches - before[n] for n, fn in wrappers.items()}
        if graphed and any(delta.values()):
            raise AssertionError('%s: a graph step launched kernels outside '
                                 'its graph: %s' % (what, delta))
        if not graphed:
            for n, d in delta.items():
                eager_launches[n] += d
    eager_per_step = {n: c // 20 for n, c in eager_launches.items() if c}
    if eager_per_step != want:
        raise AssertionError('%s: the eager step launched %s a step, the '
                             'graph holds %s' % (what, eager_per_step, want))
    replays = entry.replays - replays_before
    replayed = {short.get(k, k): n for k, n in entry.launches().items()}
    if replayed != {n: c * entry.replays for n, c in want.items()}:
        raise AssertionError('%s: replays ran %s, not the captures times '
                             '%d replays' % (what, replayed, entry.replays))
    busy = {}
    from torch.profiler import ProfilerActivity, profile
    for graphed, step in ((False, se), (True, sg)):
        torch.cuda.synchronize()
        # the device's events alone: busy needs no host-side op events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(it)
            it += 1
            torch.cuda.synchronize()
        busy[graphed] = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)) / 1000

    def med(v):
        return sorted(v)[len(v) // 2]

    rec = {'case': what, 'case_s': round(time.time() - case_start, 1),
           'capture_s': round(entry.capture_s, 3),
           'graph_pool_gib': entry.bytes_reserved / 2 ** 30,
           'loss_reward_max_rel_err': loss_err,
           'state_max_err': state_err, 'state_worst': where,
           'launches_per_step': want, 'replays_timed': replays}
    for graphed, name in ((False, 'eager'), (True, 'graph')):
        wall = med(walls[graphed])
        rec[name] = {'wall_ms_median': wall,
                     'wall_ms_min': min(walls[graphed]),
                     'wall_ms_max': max(walls[graphed]),
                     'events_ms_median': med(events[graphed]),
                     'busy_ms': busy[graphed],
                     'idle_share': 1 - busy[graphed] / wall,
                     'step_peak_gib': peak[graphed]}
    log('  %s: eager wall %.2f ms (events %.2f, busy %.2f, idle %.3f, '
        'step peak %.3f GiB); graph wall %.2f ms (events %.2f, busy %.2f, '
        'idle %.3f, pool %.3f GiB); capture %.2f s; loss / reward rel err '
        '%.1e, parameters and moments after 3 steps %.1e (%s); launches a '
        'step %s; case %.1f s'
        % (what, rec['eager']['wall_ms_median'],
           rec['eager']['events_ms_median'], busy[False],
           rec['eager']['idle_share'], peak[False],
           rec['graph']['wall_ms_median'], rec['graph']['events_ms_median'],
           busy[True], rec['graph']['idle_share'], rec['graph_pool_gib'],
           entry.capture_s, loss_err, state_err, where, want,
           rec['case_s']))
    del te, tg, se, sg, made, entry
    return rec, {n: c * replays for n, c in want.items()}


def phase_graph_train(torch, wrappers, cases=PHASE13, scorer=None):
    """Phase 13 (``scorer``: phase 11's card scorer, else one over
    ``profile_train.corpus_df``); returns the launches that the timed
    replays ran."""
    if scorer is None:
        from captioning_tpu_torch.ops.cider_device import DeviceCiderD
        from captioning_tpu_torch.tools import profile_train as pt
        scorer = DeviceCiderD(*pt.corpus_df(), device='cuda')
    launches = dict.fromkeys(wrappers, 0)
    records = []
    for kind, model, B in cases:
        rec, counts = graph_train_case(torch, kind, model, B, scorer,
                                       wrappers)
        records.append(rec)
        for name, n in counts.items():
            launches[name] += n
    log('  graph train record: %s' % json.dumps(records))
    return launches


# ---------------------------------------------------------------------------
# phase 14: AoANet, att2in and ShowTell on the card
# ---------------------------------------------------------------------------

# model -> (kernels its decodes run in both modes, in beam only), by the
# wrappers' names in chip_smoke's ``wrappers``
PHASE14 = {'aoa': ([], ['topk_lastdim']),
           'att2in': (['additive_attention', 'maxout_lstm_gates'],
                      ['topk_lastdim']),
           'show_tell': ([], ['topk_lastdim'])}
# AoANet's train steps, graph against eager (phase 13's rules)
PHASE14_TRAIN = [('xe', 'aoa', 10), ('scst', 'aoa', 10)]


def new_key_decodes(torch, model, wrappers):
    """Beam 5 and greedy of ``model`` at B = 1024, bf16, eager and graphed:
    the eager path with the counters set to 0 just before its first batch
    and its kernels required just after; the graph's capture (time, MiB)
    and held kernels (required); 3 batches a route in turns (eager, graph,
    graph, eager, eager, graph) with no wrapper launch on a graph batch;
    the replays' launches (required); graph tokens equal to eager
    (required); cap/s at each route's median; one profiled batch a route
    (device busy, idle share).  Then float32 at B = 8: the card's tokens
    equal to the CPU's (required).  Returns (record, launches)."""
    from captioning_tpu_torch.tools import profile_decode as pd
    short = {fn.__name__: name for name, fn in wrappers.items()}
    both, beam_only = PHASE14[model]
    launches = dict.fromkeys(wrappers, 0)
    record = {}
    torch.cuda.empty_cache()
    cap = pd.make_captioner(model, 'bfloat16', 'cuda')
    B = 1024
    fc, att, am = pd.features(B, 'cuda', seed=1)
    for mode in ('beam5', 'greedy'):
        required = both + (beam_only if mode == 'beam5' else [])
        for fn in wrappers.values():
            fn.launches = 0
        pd.decode(cap, mode, fc, att, am)                  # eager warm-up
        torch.cuda.synchronize()
        counts = {n: fn.launches for n, fn in wrappers.items()}
        for name in required:
            if counts[name] <= 0:
                raise AssertionError('%s was never launched on the eager '
                                     '%s %s path' % (name, model, mode))
        t = time.time()
        pd.decode(cap, mode, fc, att, am, graphed=True)
        torch.cuda.synchronize()
        first_s = time.time() - t
        entry = list(cap._graph_cache.values())[-1]
        held = {short.get(k, k): n for k, n in entry.held().items()}
        for name in required:
            if held.get(name, 0) <= 0:
                raise AssertionError('%s is not among the %s %s graphs\' '
                                     'captures %s' % (name, model, mode,
                                                      held))
        before = cap.graph_launches()
        walls = {False: [], True: []}
        outs = {}
        for graphed in (False, True, True, False, False, True):
            base = {n: fn.launches for n, fn in wrappers.items()}
            outs[graphed], wall, dev = timed(torch, lambda: pd.decode(
                cap, mode, fc, att, am, graphed=graphed))
            walls[graphed].append([round(wall, 3), round(dev, 3)])
            delta = {n: fn.launches - base[n] for n, fn in wrappers.items()}
            if graphed and any(delta.values()):
                raise AssertionError('a %s %s graph batch launched kernels '
                                     'outside its graphs: %s'
                                     % (model, mode, delta))
        prof = {name: pd.profiled(cap, mode, fc, att, am, graphed)
                for name, graphed in (('eager', False), ('graph', True))}
        replayed = {short.get(k, k): n - before.get(k, 0)
                    for k, n in cap.graph_launches().items()
                    if n - before.get(k, 0)}
        for name in required:
            if replayed.get(name, 0) <= 0:
                raise AssertionError('the %s %s graphs never ran %s'
                                     % (model, mode, name))
        (sg, stg), (se, ste) = outs[True], outs[False]
        check_output(torch, sg, stg, B, 20, pd.V)
        same = (sg == se).all(1).float().mean().item()
        rate = {name: B / (sorted(w[0] for w in walls[g])[1] / 1000)
                for name, g in (('eager', False), ('graph', True))}
        rec = {'capture_s': round(entry.capture_s, 3),
               'first_call_s': round(first_s, 3),
               'graph_cache_mib': entry.bytes_reserved / 2 ** 20,
               'held': held, 'replay_launches': replayed,
               'eager_ms_events': walls[False],
               'graph_ms_events': walls[True], 'cap_s': rate,
               'busy_ms': {k: v['device_busy_ms'] for k, v in prof.items()},
               'idle_share': {k: v['idle_share'] for k, v in prof.items()},
               'top_kernels_graph': [(k['name'][:60], round(k['ms'], 3))
                                     for k in prof['graph']['kernels'][:6]],
               'bf16_tokens_identical': same}
        log('  cap/s %s %s: eager %.1f, graph %.1f' % (
            model, mode, rate['eager'], rate['graph']))
        log('  %s %s B=1024 bf16: capture %.2f s (first call %.2f s), '
            'graph cache %.1f MiB; walls [host ms, event ms] eager %s, '
            'graph %s; busy eager %.2f / graph %.2f ms, idle eager %.3f / '
            'graph %.3f; graph tokens identical to eager %.4f; held %s, '
            'replays ran %s' % (model, mode, entry.capture_s, first_s,
                                rec['graph_cache_mib'], walls[False],
                                walls[True], rec['busy_ms']['eager'],
                                rec['busy_ms']['graph'],
                                rec['idle_share']['eager'],
                                rec['idle_share']['graph'], same, held,
                                replayed))
        if same < 1:
            raise AssertionError('bf16 %s %s: graph and eager tokens differ '
                                 '(%.4f identical): %s' % (
                                     model, mode, same, json.dumps(
                                         first_gaps(torch, cap, fc, att, am,
                                                    se, sg))))
        # the mode's eager batches (the warm-up, the walls, the profiled
        # one) and its graphs' replays
        for n, fn in wrappers.items():
            launches[n] += fn.launches + replayed.get(n, 0)
        record['%s %s' % (model, mode)] = rec
    del cap, outs, sg, se
    torch.cuda.empty_cache()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    capg = pd.make_captioner(model, 'float32', 'cuda')
    capc = pd.make_captioner(model, 'float32', 'cpu')
    fc, att, am = pd.features(8, 'cpu', seed=2)
    for fn in wrappers.values():
        fn.launches = 0
    for mode in ('beam5', 'greedy'):
        sg, stg = pd.decode(capg, mode, fc.cuda(), att.cuda(), am.cuda())
        sc, stc = pd.decode(capc, mode, fc, att, am)
        same = (sg.cpu() == sc).all(1).float().mean().item()
        err = (stg['lp_sum'].cpu() - stc['lp_sum']).abs().max().item()
        record['%s %s f32 B=8' % (model, mode)] = {
            'card_cpu_tokens_identical': same, 'lp_sum_max_diff': err}
        log('  %s f32 %s B=8: card tokens identical to the CPU\'s %.3f, max '
            'lp_sum diff %.2e' % (model, mode, same, err))
        if same < 1:
            raise AssertionError('f32 %s %s: card and CPU tokens differ '
                                 '(%.3f identical)' % (model, mode, same))
    for n, fn in wrappers.items():
        launches[n] += fn.launches
        fn.launches = 0
    del capg, capc
    torch.cuda.empty_cache()
    return record, launches


def time_b3_h2048(torch, aa):
    """B3 as att2in calls it at B = 1024 (bf16 queries and keys, the raw
    float32 regions, H 2048, A 512, M 36; beam bw 5 and greedy bw 1), and
    beam 5 with bf16 regions: held against the twin and timed (CUDA
    events, 50 launches; the twin 10) beside its bound."""
    nb, M, H, A = 1024, 36, 2048, 512
    bf16, f32 = torch.bfloat16, torch.float32
    for label, bw, att_dtype in (('bw5 f32 regions', 5, f32),
                                 ('bw1 f32 regions', 1, f32),
                                 ('bw5 bf16 regions', 5, bf16)):
        err, _ = check_additive_attention(torch, aa, nb, bw, M, H, A, bf16,
                                          seed=40 + bw, att_dtype=att_dtype)
        args = _aa_inputs(torch, nb, bw, M, H, A, bf16, seed=7,
                          ragged=False, att_dtype=att_dtype)
        fs = 4 if att_dtype == f32 else 2
        # queries, p_att, w, b in bf16; the regions and the output in the
        # regions' type; the float32 mask
        nbytes = (2 * (nb * bw * A + nb * M * A + A + 1)
                  + fs * (nb * M * H + nb * bw * H) + 4 * nb * M)
        log('  additive_attention H 2048 %s (1024 images, M 36, A 512): '
            'kernel %.4f ms, twin %.4f ms, bound %.4f ms (%s); max err vs '
            'twin %.3g' % (
                (label,
                 cuda_ms(lambda: aa.additive_attention_fused(*args), 50),
                 cuda_ms(lambda: aa.additive_attention_ref(*args), 10))
                + bound(nbytes, nb * bw * M * (3 * A + 2 * H), PEAK_F32)
                + (err,)))
        del args


def phase_new_keys(torch, aa, wrappers, scorer=None):
    """Phase 14: AoANet of ``configs/aoa.yml``, att2in and ShowTell at the
    ``opts.py`` widths: their decodes (``new_key_decodes``); AoANet's XE
    and fused SCST steps graph against eager (``graph_train_case``); one
    float32 XE step of att2in and ShowTell, card against CPU
    (``train_agreement``); B3 at att2in's H 2048.  Returns the launches of
    the phase."""
    launches = dict.fromkeys(wrappers, 0)
    records = {}
    for model in PHASE14:
        t = time.time()
        rec, counts = new_key_decodes(torch, model, wrappers)
        records.update(rec)
        for n, c in counts.items():
            launches[n] += c
        log('  %s decodes: %.1f s' % (model, time.time() - t))
    log('  new keys decode record: %s' % json.dumps(records))
    if scorer is None:
        from captioning_tpu_torch.ops.cider_device import DeviceCiderD
        from captioning_tpu_torch.tools import profile_train as pt
        scorer = DeviceCiderD(*pt.corpus_df(), device='cuda')
    for name, n in phase_graph_train(torch, wrappers, PHASE14_TRAIN,
                                     scorer).items():
        launches[name] += n
    for fn in wrappers.values():
        fn.launches = 0
    for model in ('att2in', 'show_tell'):
        train_agreement(torch, model)
    if wrappers['additive_attention'].launches <= 0 or \
            wrappers['maxout_lstm_gates'].launches <= 0:
        raise AssertionError('the att2in XE step on the card launched no B3 '
                             'or no B5')
    for n, fn in wrappers.items():
        launches[n] += fn.launches
    time_b3_h2048(torch, aa)
    return launches


# ---------------------------------------------------------------------------
# phase 15: bf16 training with float32 master weights
# ---------------------------------------------------------------------------

# the cases: each step kind and model at 10 x 5, L 16, bf16 against the
# same steps in float32 (profile_train's options, as phases 9, 11, 13, 14)
PHASE15 = [('xe', 'transformer'), ('xe', 'updown'), ('xe', 'aoa'),
           ('scst', 'transformer'), ('scst', 'updown'), ('scst', 'aoa')]


def all_float32(torch, tr, what):
    """Every parameter, gradient and optimizer moment of ``tr`` float32."""
    for n, p in tr.named_params.items():
        kinds = [('parameter', p), ('gradient', p.grad)] + [
            (k, v) for k, v in tr.optimizer.state[p].items()
            if torch.is_tensor(v) and k != 'step']
        for k, v in kinds:
            if v is None or v.dtype != torch.float32:
                raise AssertionError('%s: the %s of %s is %s, not float32'
                                     % (what, k, n, None if v is None
                                        else v.dtype))


def _route_times(torch, step, it, n, wrappers):
    """``n`` timed steps from iteration ``it``: (host walls, CUDA-event
    times, peak GiB over what was allocated before, wrapper launches)."""
    before = {k: fn.launches for k, fn in wrappers.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, events = [], []
    for i in range(n):
        _, wall, dev = timed(torch, lambda: step(it + i))
        walls.append(wall)
        events.append(dev)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return walls, events, peak, {k: fn.launches - before[k]
                                 for k, fn in wrappers.items()}


def _med(v):
    return sorted(v)[len(v) // 2]


def greedy_tokens(torch, cap, fc, att, am, graphed):
    opt = {'sample_method': 'greedy', 'beam_size': 1}
    entry = cap.sample_stats_graphed if graphed else cap.sample_stats
    return entry(fc, att, am, None, opt)[0]


def bf16_case(torch, kind, model, scorer, wrappers):
    """One case of phase 15: an eager and a graphed bf16 trainer from one
    init, batch and generator seeds, 3 steps each held bit for bit (the
    sequences, loss and reward, then every float32 parameter and Adam
    moment and every bf16 copy) and float32 throughout; the graph's held
    kernels phase 13's; 3 timed eager steps and 10 timed graph steps, and
    10 timed graph steps of the same step in float32.  UpDown's XE case
    also decodes greedy through a graph captured before the updates and
    eagerly after them: both the tokens of a fresh captioner loaded from
    the trained masters.  Returns (record, wrapper launches on the main
    path)."""
    from captioning_tpu_torch.tools import profile_train as pt
    short = {fn.__name__: name for name, fn in wrappers.items()}
    what = '%s %s 10 x 5 bf16' % (kind, model)
    start = time.time()
    torch.cuda.empty_cache()

    def make(dtype, graphed):
        if kind == 'xe':
            tr, step, _ = pt.make_step(model, 'cuda', 10, graphed=graphed,
                                       dtype=dtype)
        else:
            tr, step, _, _ = pt.make_rl_step(model, kind, 'cuda', 10, scorer,
                                             graphed=graphed, dtype=dtype)
        return tr, step

    for fn in wrappers.values():
        fn.launches = 0
    (te, se), (tg, sg) = make('bfloat16', False), make('bfloat16', True)
    if te.captioner.cfg.dtype != torch.bfloat16:
        raise AssertionError('%s: the captioner computes in %s'
                             % (what, te.captioner.cfg.dtype))
    decode_check = kind == 'xe' and model == 'updown'
    if decode_check:
        fc, att, am = (x.cuda() for x in pt.train_batch(10, 4)[:3])
        before = greedy_tokens(torch, tg.captioner, fc, att, am, True)
    for it in range(1, 4):
        oe, og = _step_out(se(it)), _step_out(sg(it))
        for key in ('greedy', 'sampled', 'loss', 'reward'):
            if key in oe and not torch.equal(oe[key], og[key]):
                raise AssertionError('%s step %d: the graph\'s %s differs '
                                     'from the eager step\'s' % (what, it,
                                                                 key))
    state_err, where = train_state_err(torch, te, tg)
    copies = [(a, b) for (_, a), (_, b) in zip(
        te.captioner._compute_pairs, tg.captioner._compute_pairs)]
    if state_err != 0 or not all(torch.equal(a, b) for a, b in copies):
        raise AssertionError('%s: after 3 steps the graph\'s state differs '
                             'from the eager step\'s (%.2e, %s)'
                             % (what, state_err, where))
    for tr in (te, tg):
        all_float32(torch, tr, what)
    if not copies or any(a.dtype != torch.bfloat16 for a, _ in copies):
        raise AssertionError('%s: no bf16 compute copies' % what)
    entry = list(tg._graphs.values())[-1]
    held = {short.get(k, k): n for k, n in entry.held().items()}
    want = PHASE13_LAUNCHES[(kind, model)]
    if held != want:
        raise AssertionError('%s: the graph holds %s, expected %s'
                             % (what, held, want))
    eager_w, eager_e, eager_peak, delta = _route_times(torch, se, 4, 3,
                                                       wrappers)
    if {n: c // 3 for n, c in delta.items() if c} != want:
        raise AssertionError('%s: the eager step launched %s in 3 steps, '
                             'the graph holds %s a step' % (what, delta,
                                                            want))
    graph_w, graph_e, graph_peak, delta = _route_times(torch, sg, 4, 10,
                                                       wrappers)
    if any(delta.values()):
        raise AssertionError('%s: a graph step launched kernels outside its '
                             'graph: %s' % (what, delta))
    rec = {'case': what, 'capture_s': round(entry.capture_s, 3),
           'graph_pool_gib': entry.bytes_reserved / 2 ** 30,
           'launches_per_step': want, 'bit_identical_3_steps': True,
           'bf16': {'eager_wall_ms': _med(eager_w),
                    'eager_events_ms': _med(eager_e),
                    'eager_peak_gib': eager_peak,
                    'graph_wall_ms': _med(graph_w),
                    'graph_wall_ms_min': min(graph_w),
                    'graph_wall_ms_max': max(graph_w),
                    'graph_events_ms': _med(graph_e),
                    'graph_peak_gib': graph_peak}}
    if decode_check:
        graphed = greedy_tokens(torch, tg.captioner, fc, att, am, True)
        eager = greedy_tokens(torch, tg.captioner, fc, att, am, False)
        fresh = type(tg.captioner)(tg.captioner.cfg, None, 'cuda')
        fresh.load_jax_variables(tg.captioner.jax_variables())
        want_tok = greedy_tokens(torch, fresh, fc, att, am, False)
        if not (torch.equal(graphed, want_tok) and torch.equal(eager,
                                                               want_tok)):
            raise AssertionError('%s: after the updates the graphed / '
                                 'eager greedy decode differs from a fresh '
                                 'captioner\'s on %d / %d rows'
                                 % (what, int((graphed != want_tok).any(1)
                                              .sum()),
                                    int((eager != want_tok).any(1).sum())))
        if len(tg.captioner._graph_cache) != 1 or torch.equal(before,
                                                              graphed):
            raise AssertionError('%s: the cached greedy graph did not '
                                 'decode the updated weights' % what)
        rec['decode_after_updates'] = 'graph = eager = fresh captioner'
        del fresh
    launches = {n: fn.launches for n, fn in wrappers.items()}
    for n, c in entry.launches().items():
        launches[short.get(n, n)] += c
    del te, tg, se, sg, entry
    torch.cuda.empty_cache()
    tf, sf = make('float32', True)
    sf(1)                            # the capture
    w, e, peak, _ = _route_times(torch, sf, 2, 10, wrappers)
    f_entry = list(tf._graphs.values())[-1]
    rec['float32'] = {'graph_wall_ms': _med(w), 'graph_wall_ms_min': min(w),
                      'graph_wall_ms_max': max(w), 'graph_events_ms': _med(e),
                      'graph_peak_gib': peak,
                      'graph_pool_gib': f_entry.bytes_reserved / 2 ** 30}
    for n, c in f_entry.launches().items():
        launches[short.get(n, n)] += c
    rec['graph_bf16_over_float32'] = (rec['bf16']['graph_events_ms']
                                      / rec['float32']['graph_events_ms'])
    rec['case_s'] = round(time.time() - start, 1)
    log('  %s: graph %.2f ms (events %.2f, peak %.3f GiB, pool %.3f GiB), '
        'eager %.2f ms (events %.2f); float32 graph %.2f ms (events %.2f, '
        'pool %.3f GiB); bf16 / float32 %.3f; 3 steps graph = eager bit for '
        'bit, parameters, gradients and moments float32; launches a step '
        '%s; case %.1f s'
        % (what, rec['bf16']['graph_wall_ms'], rec['bf16']['graph_events_ms'],
           graph_peak, rec['graph_pool_gib'], rec['bf16']['eager_wall_ms'],
           rec['bf16']['eager_events_ms'], rec['float32']['graph_wall_ms'],
           rec['float32']['graph_events_ms'],
           rec['float32']['graph_pool_gib'], rec['graph_bf16_over_float32'],
           want, rec['case_s']))
    del tf, sf, f_entry
    return rec, launches


def bf16_train_agreement(torch, model, wrappers):
    """One bf16 XE step of ``model`` at full width (2 images x 5, dropout
    0, no clip) on the card (kernels) and on the CPU (twins), and the
    CPU's float32 step: the loss within 1e-2 relative of the CPU's bf16
    one, each gradient within 2e-2 of the CPU's bf16 gradient in relative
    L2 plus twice its distance to the float32 one plus 1e-4 of the largest
    gradient norm (PERF.md's bf16 tolerance).  Returns the card
    step's wrapper launches."""
    from captioning_tpu_torch.modules.trainer import Trainer
    from captioning_tpu_torch.tools import profile_train as pt
    batch = pt.train_batch(2, seed=3)
    got = {}
    for fn in wrappers.values():
        fn.launches = 0
    for device, dtype in (('cuda', 'bfloat16'), ('cpu', 'bfloat16'),
                          ('cpu', 'float32')):
        cap = pt.train_captioner(model, device, dtype, drop_prob_lm=0.0,
                                 dropout=0.0)
        tr = Trainer(cap, pt.train_opt(grad_clip_value=0.0))
        fc, att, am, labels, masks = (x.to(device) for x in batch)
        loss = tr.xe_step(fc, att, labels, masks, am, 5e-4, 0.0,
                          torch.Generator(device).manual_seed(0))['loss']
        all_float32(torch, tr, '%s %s %s' % (model, device, dtype))
        got[device, dtype] = (float(loss), {
            n: p.grad.detach().double().cpu()
            for n, p in tr.named_params.items()})
        if device == 'cuda':
            counts = {n: fn.launches for n, fn in wrappers.items()}
        del cap, tr
    (lg, gg), (lc, gc), (_, g32) = (got['cuda', 'bfloat16'],
                                    got['cpu', 'bfloat16'],
                                    got['cpu', 'float32'])
    loss_err = abs(lg - lc) / max(abs(lc), 1e-30)
    scale = max(float(g.norm()) for g in gc.values())
    worst, where = 0.0, ''
    for n, c in gc.items():
        bound = 2e-2 * float(c.norm()) + 2 * float((c - g32[n]).norm()) \
            + 1e-4 * scale
        e = float((gg[n] - c).norm()) / bound
        if e > worst:
            worst, where = e, n
    card_far = sum(float((gg[n] - g32[n]).norm()) ** 2 for n in gc) ** 0.5
    noise = sum(float((gc[n] - g32[n]).norm()) ** 2 for n in gc) ** 0.5
    log('  %s bf16 xe_step, kernels (card) vs twins (CPU): loss %.6f vs '
        '%.6f (rel %.2e; float32 %.6f); worst gradient error over its bound '
        '%.3f (%s); the card %.3g from the float32 gradients, the CPU\'s bf16 '
        '%.3g; launches %s'
        % (model, lg, lc, loss_err, got['cpu', 'float32'][0], worst, where,
           card_far, noise, {n: c for n, c in counts.items() if c}))
    if not (loss_err <= 1e-2 and worst <= 1.0 and card_far >= 0.25 * noise):
        raise AssertionError('%s bf16 xe_step card vs CPU: loss rel err '
                             '%.2e (max 1e-2), gradient %s at %.3f of its '
                             'bound, %.3g from float32 (bf16 noise %.3g)'
                             % (model, loss_err, where, worst, card_far,
                                noise))
    return counts


def phase_bf16_train(torch, wrappers, scorer=None):
    """Phase 15; returns the launches of its main-path train steps."""
    from captioning_tpu_torch.tools import profile_train as pt
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    if scorer is None:
        from captioning_tpu_torch.ops.cider_device import DeviceCiderD
        scorer = DeviceCiderD(*pt.corpus_df(), device='cuda')
    launches = dict.fromkeys(wrappers, 0)
    counts = bf16_train_agreement(torch, 'stackatt', wrappers)
    if counts['additive_attention'] != 34 or counts['maxout_lstm_gates'] != 51:
        raise AssertionError('the StackAtt bf16 XE step on the card launched '
                             'B3 %d times and B5 %d (34 and 51 expected)'
                             % (counts['additive_attention'],
                                counts['maxout_lstm_gates']))
    for n, c in counts.items():
        launches[n] += c
    train_agreement(torch, 'updown')
    records = []
    for kind, model in PHASE15:
        rec, counts = bf16_case(torch, kind, model, scorer, wrappers)
        records.append(rec)
        for n, c in counts.items():
            launches[n] += c
    log('  bf16 train record (%s): %s' % (gpu_line(), json.dumps(records)))
    return launches


def main():
    import torch
    wall = time.time()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from captioning_tpu_torch.ops import _build
    from captioning_tpu_torch.ops import anc_attend as an
    from captioning_tpu_torch.ops import attention as aa
    from captioning_tpu_torch.ops import beam_attend as ba
    from captioning_tpu_torch.ops import logit_topk as lt
    from captioning_tpu_torch.ops import lstm as ml
    from captioning_tpu_torch.ops import mha_step as ms
    from captioning_tpu_torch.ops import topk as tk
    from captioning_tpu_torch.tools import bench_topk as bt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log('phase 1: %s' % gpu_line())
    log('torch %s, CUDA %s, %s x %d' % (torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0),
                                        torch.cuda.device_count()))
    t = time.time()
    names = ('beam_attend', 'logit_topk', 'additive_attention', 'maxout_lstm',
             'topk', 'attend')
    with ThreadPoolExecutor(len(names)) as pool:
        for path in pool.map(_build.build, names):
            log('phase 2: built %s' % os.path.relpath(path, HERE))
    log('phase 2: build %.1f s' % (time.time() - t))

    log('phase 3: kernels against their twins')
    errs = phase_kernels(torch, ba, lt)
    errs['additive_attention'] = phase_additive_attention(torch, aa)
    errs['maxout_lstm_gates'] = phase_maxout(torch, ml)
    errs['topk_lastdim'] = phase_topk(torch, tk, bt)
    times, library, (replay, b2_greedy_bound), b2_product = time_kernels(
        torch, ba, lt)
    aa_times, aa_replay = time_additive_attention(torch, aa)
    times['additive_attention'] = aa_times[5]
    new_times, new_library = time_new_kernels(torch, ml, tk, bt)
    times.update(new_times)
    library.update(new_library)
    for name, (t_ms, plain, _) in times.items():
        log('  %s: kernel %.4f ms, twin %.4f ms' % (name, t_ms, plain))
    log('  additive_attention greedy (N=1024, bw=1): kernel %.4f ms, twin '
        '%.4f ms, bound %.4f ms (%s)' % (aa_times[1][:2] + aa_times[1][2]))
    log('  additive_attention by graph replay: beam (bw 5) %.4f ms, greedy '
        '(bw 1) %.4f ms' % (aa_replay[5], aa_replay[1]))
    log('  by graph replay, ms: %s; logit_topk greedy (N 1024, k 1) bound '
        '%.4f ms' % (json.dumps(replay), b2_greedy_bound))
    log('  yardstick, not the same function: cuBLAS x @ w.T alone (bf16, '
        '[5120, 512] x [512, 9488]) %.4f ms' % b2_product)
    log('  topk_lastdim [1024, %d] by graph replay, ms: %s'
        % (bt.WIDTHS[0], json.dumps(replay_topk(torch, tk, bt))))

    # every wrapper's counter is reset before each decode mode; each mode
    # requires the kernels its path runs
    wrappers = {'attend_write_merged': ba.attend_write_merged,
                'logit_topk': lt.logit_topk,
                'additive_attention': aa.additive_attention_fused,
                'maxout_lstm_gates': ml.maxout_lstm_gates_fused,
                'topk_lastdim': tk.topk_lastdim,
                'attend_merged': ba.attend_merged,
                'mha_step_fused': ms.mha_step_fused,
                'anc_attend': an.anc_attend}
    paths = {
        'transformer': ('phase 4-5', ['attend_write_merged', 'logit_topk'],
                        []),
        'updown': ('phase 6', ['additive_attention'], ['topk_lastdim']),
        'stackatt': ('phase 7', ['additive_attention', 'maxout_lstm_gates'],
                     ['topk_lastdim']),
        'newfc': ('phase 7', ['maxout_lstm_gates'], ['topk_lastdim']),
    }
    launches = dict.fromkeys(wrappers, 0)
    rates, agree, tables = {}, {}, []
    for model, (phase, both, beam_only) in paths.items():
        log('%s: full-width %s through Captioner' % (phase, model))
        rates[model], counts, agree[model] = phase_decode(
            torch, model, [('beam5', both + beam_only), ('greedy', both)],
            wrappers, tables=tables if model == 'updown' else None)
        for name, n in counts.items():
            launches[name] += n
        if tables:
            x = tables.pop()
            bt.check(tk, x, 5, 'UpDown beam table')
            log('  topk_lastdim on the UpDown beam-5 table of step %d %s, '
                'k 5: identical to the twin, %.4f ms by graph replay'
                % (bt.CAPTURE_STEP, list(x.shape),
                   graph_ms(torch, lambda: tk.topk_lastdim(x, 5), 20)))
            del x

    log('phase 8: the strided attend kernel against its twins, and the '
        'attend benches')
    torch.cuda.empty_cache()
    errs.update(phase_attend(torch, ba, ms, an))
    attend_times, attend_library, attend_replay = time_attend(torch, ba, ms,
                                                              an)
    times.update(attend_times)
    library.update(attend_library)
    for name, (t_ms, plain, _) in attend_times.items():
        log('  %s: kernel %.4f ms, twin %.4f ms' % (name, t_ms, plain))
    log('  attend kernels by graph replay, ms: %s' % json.dumps(attend_replay))
    log('  the library attention (attend only): attend_write_merged %.4f '
        'ms, attend_merged %.4f ms, mha_step_fused %.4f ms'
        % tuple(library[n] for n in ('attend_write_merged', 'attend_merged',
                                     'mha_step_fused')))
    for name, n in phase_benches(torch, wrappers).items():
        launches[name] += n

    log('phase 9: XE training through the port\'s Trainer')
    for name, n in phase_train(torch, wrappers).items():
        launches[name] += n

    log('phase 10: the general and diverse beam, the sampling methods, the '
        'replay and diverse greedy through Captioner')
    t = time.time()
    for model, modes in PHASE10.items():
        tables = [] if model == 'transformer' else None
        mode_rates, counts, mode_agree = phase_decode(
            torch, model, modes, wrappers, tables=tables,
            table_mode='general5')
        rates.setdefault(model, {}).update(mode_rates)
        agree.setdefault(model, {}).update(mode_agree)
        for name, n in counts.items():
            launches[name] += n
        if tables:
            x = tables.pop()
            if not bool(torch.isinf(x).any()):
                raise AssertionError('the constrained general body\'s '
                                     'table holds no -inf')
            bt.check(tk, x, 5, 'constrained general-body table')
            log('  topk_lastdim on the transformer\'s constrained general-'
                'body table of step %d %s (%d entries -inf), k 5: identical '
                'to the twin, %.4f ms by graph replay'
                % (bt.CAPTURE_STEP, list(x.shape), int(torch.isinf(x).sum()),
                   graph_ms(torch, lambda: tk.topk_lastdim(x, 5), 20)))
            del x
    log('phase 10: %.1f s' % (time.time() - t))

    log('phase 11: SCST and structure training through the port\'s '
        'Trainer')
    t = time.time()
    counts, scorer = phase_rl(torch, wrappers)
    for name, n in counts.items():
        launches[name] += n
    log('phase 11: %.1f s' % (time.time() - t))

    log('phase 12: the CUDA-graph decodes against the eager ones, then '
        'the port\'s bench')
    t = time.time()
    log('  graph record: %s' % json.dumps(phase_graphs(torch, wrappers)))
    from captioning_tpu_torch.tools import bench
    _, rows, rc = bench.main([])
    if rc:
        raise AssertionError('bench: suite rows failed: %s' % json.dumps(
            {k: r for k, r in rows.items() if 'error' in r}))
    log('phase 12: %.1f s' % (time.time() - t))

    log('phase 13: the CUDA-graph train steps against the eager ones')
    t = time.time()
    for name, n in phase_graph_train(torch, wrappers,
                                     scorer=scorer).items():
        launches[name] += n
    log('phase 13: %.1f s' % (time.time() - t))

    log('phase 14: AoANet, att2in and ShowTell through Captioner and '
        'Trainer')
    t = time.time()
    for name, n in phase_new_keys(torch, aa, wrappers, scorer).items():
        launches[name] += n
    log('phase 14: %.1f s' % (time.time() - t))

    log('phase 15: bf16 training with float32 master weights')
    t = time.time()
    for name, n in phase_bf16_train(torch, wrappers, scorer).items():
        launches[name] += n
    log('phase 15: %.1f s' % (time.time() - t))

    bad = [m for m in sys.modules
           if m.split('.')[0] in ('jax', 'flax', 'optax', 'captioning_tpu')]
    if bad:
        raise AssertionError('imported from the JAX side: %s' % bad[:5])

    replaces = {'attend_write_merged':
                ('captioning_tpu_torch/csrc/beam_attend.cu',
                 'captioning_tpu/ops/beam_attend.py:208'),
                'logit_topk': ('captioning_tpu_torch/csrc/logit_topk.cu',
                               'captioning_tpu/ops/logit_topk.py:53'),
                'additive_attention':
                ('captioning_tpu_torch/csrc/additive_attention.cu',
                 'captioning_tpu/ops/attention.py:56'),
                'maxout_lstm_gates':
                ('captioning_tpu_torch/csrc/maxout_lstm.cu',
                 'captioning_tpu/ops/lstm.py:31'),
                'topk_lastdim': ('captioning_tpu_torch/csrc/topk.cu',
                                 'captioning_tpu/ops/topk.py:37'),
                'attend_merged': ('captioning_tpu_torch/csrc/attend.cu',
                                  'captioning_tpu/ops/beam_attend.py:98'),
                'mha_step_fused': ('captioning_tpu_torch/csrc/attend.cu',
                                   'captioning_tpu/ops/mha_step.py:64'),
                'anc_attend': ('captioning_tpu_torch/csrc/attend.cu',
                               'captioning_tpu/ops/anc_attend.py:93')}
    kernels = [{'name': name, 'route': 'cuda', 'source': src,
                'replaces': rep, 'launches': launches[name],
                'max_abs_err': errs[name], 'ms': times[name][0],
                'plain_ms': times[name][1], 'bound_ms': times[name][2][0],
                'bound_by': times[name][2][1],
                'library_ms': library.get(name)}
               for name, (src, rep) in replaces.items()]
    log('wall %.1f s' % (time.time() - wall))
    log('cap/s: %s' % json.dumps(rates))
    log('f32 caption agreement, kernels vs twins: %s' % json.dumps(agree))
    log(gpu_line())
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
