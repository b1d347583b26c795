#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``captioning_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the three CUDA kernels from ``captioning_tpu_torch/csrc`` (one
   nvcc per source, all started together);
3. hold each kernel against its plain PyTorch twin on the card at the main
   paths' shapes (B1: N = 5120 beam rows and N = 1024 greedy rows,
   D = 512, 8 heads, Tp in {8, 24, 32, 48}, bw in {5, 1}; B2: V1 = 9488,
   k in {5, 1}, temperature 0.8, UNK bias on; B3: 1024 images, bw in
   {1, 5}, M = 36, H = 1000, A = 512), in float32 with tight tolerances and
   in bf16 with stated ones, plus ragged small shapes;
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
   runs kernel B3 on every step.

The last two lines are the kernels' JSON record and
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
    return err


def time_additive_attention(torch, aa):
    """Kernel vs twin device time at the UpDown step shapes, bf16, for
    beam 5 (bw = 5) and greedy (bw = 1) at B = 1024."""
    out = {}
    for bw in (5, 1):
        args = _aa_inputs(torch, 1024, bw, 36, 1000, 512, torch.bfloat16,
                          seed=7, ragged=False)
        out[bw] = (cuda_ms(lambda: aa.additive_attention_fused(*args), 50),
                   cuda_ms(lambda: aa.additive_attention_ref(*args), 20))
    return out


def time_kernels(torch, ba, lt):
    """Kernel vs twin device time at the beam-5 B=1024 step shapes, bf16."""
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
    out['attend_write_merged'] = (
        cuda_ms(lambda: ba.attend_write_merged(q, k, v, kn, vn, anc, t0,
                                               bw=bw, h=h), 50),
        cuda_ms(lambda: ba.attend_write_merged_ref(q, k, v, kn, vn, anc, t0,
                                                   bw=bw, h=h), 50))
    V1 = 9488
    x, w, b = rnd(N, D), rnd(V1, D) * 0.1, rnd(V1) * 0.1
    out['logit_topk'] = (
        cuda_ms(lambda: lt.logit_topk(x, w, b, 0.8, -1000.0, k=5,
                                      unk_idx=V1 - 1), 10),
        cuda_ms(lambda: lt.logit_topk_ref(x, w, b, 0.8, -1000.0, k=5,
                                          unk_idx=V1 - 1), 10))
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the model through Captioner
# ---------------------------------------------------------------------------

V = 9487


# the flagships' widths: configs/transformer/transformer.yml and
# configs/updown/updown.yml (the shapes bench.py measures)
MODELS = {
    'transformer': dict(input_encoding_size=512, rnn_size=2048, num_layers=6,
                        drop_prob_lm=0.1, att_hid_size=512, N_enc=6, N_dec=6,
                        d_model=512, d_ff=2048, num_att_heads=8),
    'updown': dict(input_encoding_size=1000, rnn_size=1000, num_layers=2,
                   drop_prob_lm=0.5, att_hid_size=512),
}


def make_captioner(torch, model, dtype_name, device):
    from types import SimpleNamespace

    from captioning_tpu_torch.models.api import setup
    opt = SimpleNamespace(caption_model=model, vocab_size=V,
                          fc_feat_size=2048, att_feat_size=2048,
                          max_length=20, compute_dtype=dtype_name,
                          **MODELS[model])
    vocab = {str(i): 'w%d' % i for i in range(1, V + 1)}
    vocab[str(V)] = 'UNK'          # the COCO vocab's last entry
    return setup(opt, vocab, device).init_params(
        torch.Generator().manual_seed(0))


def features(torch, B, device, seed):
    """36 x 2048 region features and their mean as the fc feature, as the
    bottom-up features give them."""
    g = torch.Generator().manual_seed(seed)
    att = torch.randn(B, 36, 2048, generator=g).to(device)
    fc = att.mean(1)
    am = torch.ones(B, 36, device=device)
    return fc, att, am


BEAM = {'beam_size': 5, 'sample_n': 1, 'group_size': 1, 'suppress_UNK': 1}
GREEDY = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}


def decode(cap, mode, fc, att, am):
    if mode == 'beam5':
        seq, stats, _ = cap.sample_beam(fc, att, am, None, BEAM)
    else:
        seq, stats = cap.sample_stats(fc, att, am, None, GREEDY)
    return seq, stats


def check_output(torch, seq, stats, B, L):
    if tuple(seq.shape) != (B, L) or int(seq.min()) < 0 or int(
            seq.max()) > V:
        raise AssertionError('decode output: shape %s range [%d, %d]'
                             % (tuple(seq.shape), int(seq.min()),
                                int(seq.max())))
    for key in ('ent_sum', 'lp_sum'):
        if not bool(torch.isfinite(stats[key]).all()):
            raise AssertionError('decode output: %s not finite' % key)
    if not bool((stats['lp_sum'] <= 0).all()):
        raise AssertionError('decode output: positive logprob sum')


def phase_decode(torch, model, wrappers, batches=3):
    """Beam 5 and greedy at B = 1024, bf16, through ``Captioner``; each
    mode runs with the launch counters of ``wrappers`` (name -> wrapper)
    set to 0 just before it, and every one must have grown just after.
    Then the f32 agreement of the kernels (CUDA) with the twins (CPU)."""
    torch.cuda.empty_cache()      # earlier phases' blocks: a clean pool
    cap = make_captioner(torch, model, 'bfloat16', 'cuda')
    B, L = 1024, 20
    fc, att, am = features(torch, B, 'cuda', seed=1)
    rates = {}
    launches = dict.fromkeys(wrappers, 0)
    for mode in ('beam5', 'greedy'):
        for fn in wrappers.values():
            fn.launches = 0
        seq, stats = decode(cap, mode, fc, att, am)     # warm-up
        torch.cuda.synchronize()
        check_output(torch, seq, stats, B, L)
        ms = []
        for _ in range(batches):
            t = time.time()
            seq, stats = decode(cap, mode, fc, att, am)
            torch.cuda.synchronize()
            ms.append(1000 * (time.time() - t))
            check_output(torch, seq, stats, B, L)
        counts = {name: fn.launches for name, fn in wrappers.items()}
        for name, n in counts.items():
            if n <= 0:
                raise AssertionError('%s was never launched on the %s %s '
                                     'path' % (name, model, mode))
            launches[name] += n
        rates[mode] = B / (sorted(ms)[batches // 2] / 1000)
        steps = int((seq > 0).sum(1).max()) + 1
        log('  %s %s B=%d: %.1f cap/s at the median batch (ms per batch: '
            '%s; longest caption %d steps), mean ent_sum %.3f, launches %s'
            % (model, mode, B, rates[mode], ', '.join('%.1f' % v for v in ms),
               steps, float(stats['ent_sum'].mean()), counts))
    del cap

    # f32: kernels (CUDA) against twins (CPU) on one small batch
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    agree = {}
    capg = make_captioner(torch, model, 'float32', 'cuda')
    capc = make_captioner(torch, model, 'float32', 'cpu')
    fc, att, am = features(torch, 8, 'cpu', seed=2)
    for mode in ('beam5', 'greedy'):
        sg, stg = decode(capg, mode, fc.cuda(), att.cuda(), am.cuda())
        sc, stc = decode(capc, mode, fc, att, am)
        same = (sg.cpu() == sc).all(1).float().mean().item()
        err = (stg['ent_sum'].cpu() - stc['ent_sum']).abs().max().item()
        agree[mode] = same
        log('  %s f32 %s: captions identical kernels vs twins %.3f, max '
            'ent_sum diff %.2e' % (model, mode, same, err))
        if same < 0.75:
            raise AssertionError('f32 decode: kernels and twins agree on '
                                 'only %.3f of the captions' % same)
    return rates, launches, agree


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from captioning_tpu_torch.ops import _build
    from captioning_tpu_torch.ops import attention as aa
    from captioning_tpu_torch.ops import beam_attend as ba
    from captioning_tpu_torch.ops import logit_topk as lt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log('phase 1: %s' % gpu_line())
    log('torch %s, CUDA %s, %s x %d' % (torch.__version__, torch.version.cuda,
                                        torch.cuda.get_device_name(0),
                                        torch.cuda.device_count()))
    t = time.time()
    names = ('beam_attend', 'logit_topk', 'additive_attention')
    with ThreadPoolExecutor(len(names)) as pool:
        for path in pool.map(_build.build, names):
            log('phase 2: built %s' % os.path.relpath(path, HERE))
    log('phase 2: build %.1f s' % (time.time() - t))

    log('phase 3: kernels against their twins')
    errs = phase_kernels(torch, ba, lt)
    errs['additive_attention'] = phase_additive_attention(torch, aa)
    times = time_kernels(torch, ba, lt)
    aa_times = time_additive_attention(torch, aa)
    times['additive_attention'] = aa_times[5]
    for name, (ms, plain) in times.items():
        log('  %s: kernel %.4f ms, twin %.4f ms' % (name, ms, plain))
    log('  additive_attention greedy (N=1024, bw=1): kernel %.4f ms, twin '
        '%.4f ms' % aa_times[1])

    log('phase 4-5: full-width transformer through Captioner')
    rates, launches, agree = phase_decode(
        torch, 'transformer', {'attend_write_merged': ba.attend_write_merged,
                               'logit_topk': lt.logit_topk})
    log('phase 6: full-width UpDown through Captioner')
    u_rates, u_launches, u_agree = phase_decode(
        torch, 'updown',
        {'additive_attention': aa.additive_attention_fused})
    launches.update(u_launches)

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
                 'captioning_tpu/ops/attention.py:56')}
    kernels = [{'name': name, 'route': 'cuda', 'source': src,
                'replaces': rep, 'launches': launches[name],
                'max_abs_err': errs[name], 'ms': times[name][0],
                'plain_ms': times[name][1]}
               for name, (src, rep) in replaces.items()]
    log('cap/s: transformer %s, updown %s; f32 caption agreement: '
        'transformer %s, updown %s' % (json.dumps(rates), json.dumps(u_rates),
                                       json.dumps(agree), json.dumps(u_agree)))
    log(gpu_line())
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
