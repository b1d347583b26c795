"""The port's bench: captions per second of the flagship transformer's
beam-5 eval decode through the CUDA-graph decode, its MFU, and the suite
rows.  Port of the repo's root ``bench.py`` (the JAX package's bench).

    python -m captioning_tpu_torch.tools.bench [--device cuda|cpu]
        [--batch 1024] [--iters 10] [--small] [--suite 1|0] [--seed 0]

Headline: the transformer at the shapes of ``bench.py:91-111`` (6 + 6
layers, d_model 512, d_ff 2048, 8 heads, COCO vocab 9487 + 1, 36 x 2048
features, max length 20), bf16, random weights from the port's init with a
seeded generator, beam 5 with ``suppress_UNK``, B = 1024, through
``Captioner.sample_beam_graphed``.  The first call warms up and captures
the graphs (``capture_s``, where the JAX bench reports ``compile_s``);
then ``--iters`` batches run pipelined as ``bench.py:136-155`` runs them
(batch i's tokens and sums are fetched after batch i+1 has been issued,
as ``eval_split`` defers its reads), and synced at the end.  Reported: the
median batch wall and its min-max spread, captions/s at the median, each
batch's CUDA-event time (on the card), and the MFU of a copy of
``bench.py``'s ``decode_step_flops`` at the median against the card's
published dense bf16 peak (``PEAK_BF16_TFLOPS``, by
``torch.cuda.get_device_name``; an unknown card raises), with the card's
name and power limit.  The JSON line keeps ``metric``, ``value``, ``unit``
and ``mfu_pct``; it drops ``vs_baseline`` (an estimate never measured on a
card) and ``compile_cache`` (the JAX package's compile cache).

Suite rows (``bench.py:221-305``), each on its own line with its spread:
``greedy_cap_s`` (the transformer greedy, graphed), ``updown_beam5_cap_s``
(UpDown at ``bench.py:287-304``'s widths, graphed), ``xe_img_s`` (the
transformer's ``Trainer.xe_step_graphed`` at 128 images x 5, label length
18, ``bench.py:308``'s options) and ``scst_fused_s_iter`` (its
``sc_fused_step_graphed`` at 50 x 5 with ``bench.py:264-276``'s df table
and ref_len), in float32, and ``xe_img_s_bf16`` / ``scst_fused_s_iter_bf16``,
the same steps at ``compute_dtype`` bfloat16 with float32 master weights,
the dtype the root bench trains in (``bench.py:97``); each train row says
its ``dtype`` and carries the eager step's numbers (``xe_step`` /
``sc_fused_step``, timed first on the same trainer) under ``eager``.  A failing row is printed with its error, and the bench then
exits non-zero.  ``--suite 0`` is the JAX bench's ``BENCH_SUITE=0``.

``--small`` builds every model at the widths a CPU run takes (2 + 2
layers, d_model 32, vocab 20, 5 regions x 12 features); on the CPU the
graphed entries run their programs eagerly and no device time exists.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

V = 9487
REGIONS, FEAT = 36, 2048
BEAM = {'beam_size': 5, 'sample_n': 1, 'group_size': 1, 'suppress_UNK': 1}
GREEDY = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}
XE_IMAGES, XE_LEN, SC_IMAGES = 128, 18, 50
# published dense bf16 peaks (TFLOP/s) by torch.cuda.get_device_name
PEAK_BF16_TFLOPS = {'NVIDIA H100 80GB HBM3': 989.4}
# the --small widths
SMALL = dict(V=20, REGIONS=5, FEAT=12)


def decode_step_flops(opt, n_mem: int, cache_len: int) -> float:
    """FLOP model of ONE transformer decode step for ONE lane.

    Matmul FLOPs only (2*m*n*k), the >99% term: per layer the q/k/v/o
    self projections (8d^2), the ancestry attend over the cache (4*T*d),
    the lazy cross-attention (8d^2 fold/projections + 4*M*d scores/ctx),
    the FFN (4*d*ff); plus the vocab logits (2*d*V).  Layernorms,
    softmaxes and the embedding gather are bandwidth, not FLOPs, and are
    deliberately excluded — this is the numerator of an honest MFU.

    The ancestry-attend term counts ALGORITHMIC FLOPs (4*T*d per lane:
    one score + one weighted-sum pass over the lane's own history).  The
    executed ``_attend_beam`` computes scores/context against all bw
    sibling slots and masks (4*bw*T*d executed), so the hardware runs
    ~bw-fold more attend FLOPs than this numerator credits — at the
    headline shape that term is <2%% of the step's FLOPs, and the useful
    -work convention keeps mfu_pct meaning "progress on the problem",
    not "MXU occupancy".
    """
    d, f, L = opt.d_model, opt.d_ff, opt.N_dec
    per_layer = 16.0 * d * d + 4.0 * cache_len * d + 4.0 * n_mem * d \
        + 4.0 * d * f
    return L * per_layer + 2.0 * d * (opt.vocab_size + 1)


def peak_bf16_tflops(name: str) -> float:
    """The card's published dense bf16 peak; an unknown card raises."""
    if name not in PEAK_BF16_TFLOPS:
        raise KeyError('no published bf16 peak for %r (known: %s): add it '
                       'to PEAK_BF16_TFLOPS'
                       % (name, sorted(PEAK_BF16_TFLOPS)))
    return PEAK_BF16_TFLOPS[name]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def model_opt(model: str, small: bool, dtype: str, **kw):
    """The options of ``bench.py``'s transformer (``:91-111``) or UpDown
    (``:287-304``), at the --small widths if asked."""
    if model == 'transformer':
        widths = dict(input_encoding_size=512, rnn_size=2048, num_layers=6,
                      att_hid_size=512, N_enc=6, N_dec=6, d_model=512,
                      d_ff=2048, num_att_heads=8)
        small_widths = dict(input_encoding_size=16, rnn_size=32,
                            num_layers=2, att_hid_size=16, N_enc=2, N_dec=2,
                            d_model=32, d_ff=48, num_att_heads=4)
    else:
        widths = dict(input_encoding_size=1000, rnn_size=1000, num_layers=2,
                      att_hid_size=512)
        small_widths = dict(input_encoding_size=20, rnn_size=24,
                            num_layers=2, att_hid_size=12)
    v, feat = (SMALL['V'], SMALL['FEAT']) if small else (V, FEAT)
    return SimpleNamespace(**dict(
        dict(caption_model=model, vocab_size=v, drop_prob_lm=0.5,
             fc_feat_size=feat, att_feat_size=feat, seq_per_img=5,
             max_length=20, compute_dtype=dtype, dropout=0.1),
        **(small_widths if small else widths), **kw))


def make_captioner(opt, device, seed):
    from ..models.api import setup
    vocab = {str(i): 'w%d' % i for i in range(1, opt.vocab_size + 1)}
    return setup(opt, vocab, device).init_params(
        torch.Generator().manual_seed(seed))


def features(B: int, small: bool, device, seed: int):
    """fc [B, FEAT], att [B, REGIONS, FEAT] from a seeded normal, every
    region valid (as ``bench.py`` makes them)."""
    regions, feat = ((SMALL['REGIONS'], SMALL['FEAT']) if small
                     else (REGIONS, FEAT))
    g = torch.Generator().manual_seed(seed)
    fc = torch.randn(B, feat, generator=g)
    att = torch.randn(B, regions, feat, generator=g)
    return (fc.to(device), att.to(device),
            torch.ones(B, regions, device=device))


def pipelined(fn, fetch, iters: int, device):
    """Batch i's ``fetch`` after batch i+1 is issued (``bench.py``'s
    ``_pipelined``), after one warm-up call.  Returns (walls [s], device
    times [ms] or None on the CPU): batch i's wall runs from its issue to
    the issue of batch i+1 (the last: to its fetch); its device time is
    the CUDA-event span of its call on the current stream."""
    cuda = torch.device(device).type == 'cuda'
    fetch(fn(-1))
    if cuda:
        torch.cuda.synchronize()
    events, marks, prev = [], [], None
    for i in range(iters):
        marks.append(time.perf_counter())
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        r = fn(i)
        if cuda:
            end.record()
            events.append((start, end))
        if prev is not None:
            fetch(prev)
        prev = r
    fetch(prev)
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.perf_counter())
    walls = [b - a for a, b in zip(marks, marks[1:])]
    device_ms = [s.elapsed_time(e) for s, e in events] if cuda else None
    return walls, device_ms


def spread(walls, device_ms, per_batch: float, unit: str, **extra):
    """A row: ``per_batch`` units over the median wall, with the min-max
    and the median device time."""
    ordered = sorted(walls)
    med = ordered[len(ordered) // 2]
    row = {'value': per_batch / med if unit != 's/iter' else med,
           'unit': unit, 'batch_s_median': med, 'batch_s_min': ordered[0],
           'batch_s_max': ordered[-1], 'iters': len(walls),
           'device_ms_median': (sorted(device_ms)[len(device_ms) // 2]
                                if device_ms else None)}
    row.update(extra)
    return row


def _fetch_decode(r):
    """The host's reads of a decode: tokens and a sum."""
    r[0].cpu()
    r[1]['ent_sum'].cpu()


def decode_row(cap, entry: str, opt, fc, att, am, iters, device):
    fn = getattr(cap, entry)
    walls, dev = pipelined(lambda i: fn(fc, att, am, None, opt),
                           _fetch_decode, iters, device)
    return spread(walls, dev, fc.shape[0], 'captions/s',
                  dtype=str(cap.cfg.dtype).replace('torch.', ''))


def _train_opt(opt):
    """Trainer options over the bench model shapes (``bench.py:308``)."""
    t = SimpleNamespace(**vars(opt))
    t.optim = 'adam'
    t.learning_rate = 4e-4
    t.optim_alpha, t.optim_beta, t.optim_epsilon = 0.9, 0.999, 1e-8
    t.weight_decay = 0
    t.grad_clip_mode, t.grad_clip_value = 'value', 0.1
    t.label_smoothing = 0
    t.noamopt = False
    t.drop_worst_rate = 0
    t.cider_reward_weight = 1.0
    t.bleu_reward_weight = 0.0
    t.sc_sample_method = 'greedy'
    t.sc_beam_size = 1
    t.train_sample_method = 'sample'
    t.train_beam_size = 1
    t.train_sample_n = 5
    return t


def _eager_beside(row, eager):
    """``row`` (the graphed step's) with the eager step's numbers; a
    failure of either step is the row's error."""
    if 'error' in eager:
        return {'error': 'eager step: %s' % eager['error']}
    if 'error' not in row:
        row['eager'] = {k: eager[k] for k in (
            'value', 'batch_s_median', 'batch_s_min', 'batch_s_max',
            'device_ms_median')}
    return row


def train_rows(small, device, seed, iters, B, dtype='float32'):
    """``xe_img_s`` and ``scst_fused_s_iter``: the transformer's train
    steps (``bench.py:236-276``) at the compute ``dtype`` (float32 master
    weights at either; the rows of bfloat16 end in ``_bf16``), graphed,
    with the eager step's numbers beside."""
    from ..modules.trainer import Trainer
    from ..ops.cider_device import DeviceCiderD, pad_gts
    suffix = '' if dtype == 'float32' else '_bf16'
    opt = model_opt('transformer', small, dtype)
    trainer = Trainer(make_captioner(opt, device, seed), _train_opt(opt))
    fc, att, am = features(max(XE_IMAGES, SC_IMAGES), small, device,
                           seed + 1)
    g = torch.Generator().manual_seed(seed + 2)
    rows = {}
    xb = min(XE_IMAGES, B)
    labels = torch.randint(1, opt.vocab_size, (xb, 5, XE_LEN),
                           generator=g).to(device)
    masks = torch.ones(xb, 5, XE_LEN, device=device)
    gen = torch.Generator(device).manual_seed(seed)

    def xe_row(step):
        try:
            walls, dev = pipelined(
                lambda i: step(fc[:xb], att[:xb], labels, masks, am[:xb],
                               4e-4, 0.0, gen)['loss'], float, iters, device)
            return spread(walls, dev, xb * 5, 'images x captions/s',
                          dtype=dtype, batch=[xb, 5, XE_LEN])
        except Exception as e:       # a failing row is reported, not hidden
            return {'error': repr(e)}

    eager = xe_row(trainer.xe_step)
    rows['xe_img_s' + suffix] = _eager_beside(
        xe_row(trainer.xe_step_graphed), eager)

    sb = min(SC_IMAGES, B)
    gts = [torch.randint(1, opt.vocab_size, (5, 16), generator=g).numpy()
           .astype('int32') for _ in range(sb)]
    refs, ref_mask = (torch.from_numpy(x).to(device)
                      for x in pad_gts(gts, pad_to_multiple=5))
    scorer = DeviceCiderD({(i,): 2.0 for i in range(1, 50)}, ref_len=1000.0,
                          device=device)
    noise = torch.Generator(device).manual_seed(seed + 3)

    def sc_row(step):
        try:
            walls, dev = pipelined(
                lambda i: step(fc[:sb], att[:sb], am[:sb], refs, ref_mask,
                               4e-4, noise, noise, gen, scorer)['loss'],
                float, iters, device)
            return spread(walls, dev, 1, 's/iter', dtype=dtype,
                          batch=[sb, 5])
        except Exception as e:       # a failing row is reported, not hidden
            return {'error': repr(e)}

    eager = sc_row(trainer.sc_fused_step)
    rows['scst_fused_s_iter' + suffix] = _eager_beside(
        sc_row(trainer.sc_fused_step_graphed), eager)
    return rows


def suite(cap, fc, att, am, args):
    """The suite rows, each computed on its own: a failure is the row's
    ``error``."""
    rows = {}
    try:
        rows['greedy_cap_s'] = decode_row(cap, 'sample_stats_graphed', GREEDY,
                                          fc, att, am, args.iters,
                                          args.device)
    except Exception as e:           # a failing row is reported, not hidden
        rows['greedy_cap_s'] = {'error': repr(e)}
    try:
        ucap = make_captioner(model_opt('updown', args.small, 'bfloat16'),
                              args.device, args.seed)
        rows['updown_beam5_cap_s'] = decode_row(
            ucap, 'sample_beam_graphed', BEAM, fc, att, am, args.iters,
            args.device)
        del ucap
    except Exception as e:           # a failing row is reported, not hidden
        rows['updown_beam5_cap_s'] = {'error': repr(e)}
    if torch.device(args.device).type == 'cuda':
        torch.cuda.empty_cache()
    for dtype in ('float32', 'bfloat16'):
        rows.update(train_rows(args.small, args.device, args.seed,
                               args.iters, args.batch, dtype))
        if torch.device(args.device).type == 'cuda':
            torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--device', default='cuda')
    p.add_argument('--batch', type=int, default=1024)
    p.add_argument('--iters', type=int, default=10)
    p.add_argument('--small', action='store_true',
                   help='the widths a CPU run takes')
    p.add_argument('--suite', type=int, default=1, choices=(0, 1))
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    cuda = torch.device(args.device).type == 'cuda'
    if cuda and not torch.cuda.is_available():
        raise SystemExit('bench: --device %s but no CUDA device is available '
                         '(--device cpu runs the programs eagerly)'
                         % args.device)
    if cuda:
        name = torch.cuda.get_device_name(args.device)
        peak = peak_bf16_tflops(name) * 1e12
        card = card_line()
    else:
        name, peak, card = 'cpu', None, None
    opt = model_opt('transformer', args.small, 'bfloat16')
    cap = make_captioner(opt, args.device, args.seed)
    fc, att, am = features(args.batch, args.small, args.device,
                           args.seed + 1)

    start = time.time()
    _fetch_decode(cap.sample_beam_graphed(fc, att, am, None, BEAM))
    capture_s = time.time() - start
    walls, dev = pipelined(
        lambda i: cap.sample_beam_graphed(fc, att, am, None, BEAM),
        _fetch_decode, args.iters, args.device)
    row = spread(walls, dev, args.batch, 'captions/s')
    steps = opt.max_length + 1
    flops = (decode_step_flops(opt, n_mem=att.shape[1], cache_len=steps)
             * args.batch * BEAM['beam_size'] * steps)
    head = {'metric': 'captions_per_sec_per_chip_beam5_transformer',
            'value': row.pop('value'), 'unit': 'captions/s',
            'mfu_pct': (100.0 * flops / row['batch_s_median'] / peak
                        if peak else None),
            'capture_s': capture_s, 'batch': args.batch, 'dtype': 'bfloat16',
            'device': name, 'card': card}
    head.update(row)
    print(json.dumps(head), flush=True)
    print('details: %.1f MFLOP a lane a step, %d steps, peak %s TFLOP/s'
          % (flops / args.batch / BEAM['beam_size'] / steps / 1e6, steps,
             peak / 1e12 if peak else 'n/a'), file=sys.stderr, flush=True)
    rows = {}
    if args.suite:
        rows = suite(cap, fc, att, am, args)
        for key, r in rows.items():
            print(json.dumps(dict({'row': key}, **r)), flush=True)
    failed = [k for k, r in rows.items() if 'error' in r]
    if failed:
        print('bench: suite rows failed: %s' % ', '.join(failed),
              file=sys.stderr)
    return head, rows, 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main()[2])
