"""Profile one eval-decode batch of a full-width captioner on the GPU with
``torch.profiler``: wall, device busy, idle share and the kernels that
take the device time.

    python -m captioning_tpu_torch.tools.profile_decode \\
        [--model transformer|bert|m2transformer|updown|stackatt|newfc|aoa|
                 att2in|show_tell]
        [--mode beam5|greedy|...]

The model is built at the flagship widths (``MODELS``: the transformer of
``configs/transformer/transformer.yml``, and bert and m2transformer at its
widths (they have no config of their own), UpDown of
``configs/updown/updown.yml``, StackAtt at the ``opts.py`` widths, NewFC
of ``configs/fc.yml``, AoANet of ``configs/aoa.yml``, att2in and
ShowTell at the ``opts.py`` widths; COCO vocab 9487 + 1, 36 x 2048
features, max
length 20, bf16, B = 1024) with random weights from a seed, as
``chip_smoke.py`` builds it, and decodes by one of ``MODES`` (beam 5 and
greedy, and phase 10's: the constrained general beam body, diverse beam,
sample_n 5 by four methods, the replay, diverse greedy) on a route:
``eager`` (``sample_beam`` / ``sample_stats`` / ``sample``), ``graph``
(``sample_beam_graphed`` / ``sample_stats_graphed``: beam 5 and greedy
only) or ``both``, taken in turns.  One warm-up batch a route (the graph
route's captures its graphs), 3 unprofiled batches a route (host clock
ending in a synchronize; with ``both`` in the order eager, graph, graph,
eager, eager, graph), then one profiled batch a route.  Device busy is the
sum of the self device time of the profiler's device events (each kernel
once); idle share = 1 - busy / the profiled batch's wall.  A graph
replay's kernels reach the profiler as kernels like any other (its
launch is one host event, ``cudaGraphLaunch``), so the graph route's busy
and idle share are read the same way: the idle share is then the time
the card waits between replays (the host's flag read a step and the
next launch) and on the batch's eager ends (the input copies, the
outputs' clones).  The profiler slows a host-bound decode, so both walls
are printed, and the 15 kernels that take the most device time.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

V = 9487
REGIONS, FEAT = 36, 2048        # bottom-up features: 36 regions x 2048
BATCH, WALLS, TOP = 1024, 3, 15
# the flagships' widths: configs/transformer/transformer.yml and
# configs/updown/updown.yml (the shapes bench.py measures); StackAtt at the
# opts.py defaults (captioning_tpu/utils/opts.py:45-65); NewFC of
# configs/fc.yml (MODEL_ZOO row "FC", the opts.py widths); AoANet of
# configs/aoa.yml (rnn and encoding 1024, the 6-layer refiner with the AoA
# gate, 8 heads, the AoA decoder); att2in and ShowTell (one LSTM layer) at
# the opts.py widths
MODELS = {
    'transformer': dict(input_encoding_size=512, rnn_size=2048, num_layers=6,
                        drop_prob_lm=0.1, att_hid_size=512, N_enc=6, N_dec=6,
                        d_model=512, d_ff=2048, num_att_heads=8),
    'updown': dict(input_encoding_size=1000, rnn_size=1000, num_layers=2,
                   drop_prob_lm=0.5, att_hid_size=512),
    'stackatt': dict(input_encoding_size=512, rnn_size=512, num_layers=1,
                     drop_prob_lm=0.5, att_hid_size=512),
    'newfc': dict(input_encoding_size=512, rnn_size=512, num_layers=1,
                  drop_prob_lm=0.5, att_hid_size=512),
    'aoa': dict(input_encoding_size=1024, rnn_size=1024, num_layers=2,
                drop_prob_lm=0.5, att_hid_size=512, refine=1, refine_aoa=1,
                use_ff=0, decoder_type='AoA', use_multi_head=2, num_heads=8,
                multi_head_scale=1, mean_feats=1, ctx_drop=1,
                dropout_aoa=0.3),
    'att2in': dict(input_encoding_size=512, rnn_size=512, num_layers=1,
                   drop_prob_lm=0.5, att_hid_size=512),
    'show_tell': dict(input_encoding_size=512, rnn_size=512, num_layers=1,
                      drop_prob_lm=0.5, att_hid_size=512, rnn_type='lstm'),
}
# bert and m2transformer have no config: the transformer's widths
MODELS['bert'] = MODELS['m2transformer'] = MODELS['transformer']
BEAM = {'beam_size': 5, 'sample_n': 1, 'group_size': 1, 'suppress_UNK': 1}
GREEDY = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}
DBS = {'beam_size': 6, 'group_size': 3, 'diversity_lambda': 0.5,
       'sample_n': 1, 'suppress_UNK': 1}
# mode -> (entry point, options, captions an image): the eval decodes
# (beam 5, greedy) and the rest of the engine (the general beam body with
# the constraints, diverse beam, sample_n 5 by four methods, the replay,
# diverse greedy in 5 groups)
MODES = {
    'beam5': ('beam', BEAM, 1),
    'greedy': ('stats', GREEDY, 1),
    'general5': ('beam', dict(BEAM, decoding_constraint=1,
                              remove_bad_endings=1), 1),
    'dbs6g3': ('beam', DBS, 1),
    'sample5': ('sample', {'sample_method': 'sample', 'sample_n': 5,
                           'beam_size': 1}, 5),
    'top3x5': ('sample', {'sample_method': 'top3', 'sample_n': 5,
                          'beam_size': 1}, 5),
    'top0.9x5': ('sample', {'sample_method': 'top0.9', 'sample_n': 5,
                            'beam_size': 1}, 5),
    'gumbel5': ('sample', {'sample_method': 'gumbel', 'sample_n': 5,
                           'beam_size': 1}, 5),
    'replay5': ('replay', BEAM, 1),
    'dgreedy5': ('sample', {'sample_method': 'greedy', 'group_size': 5,
                            'diversity_lambda': 0.5, 'beam_size': 1}, 5),
}


def model_opt(model: str, dtype_name: str) -> SimpleNamespace:
    """The options of ``model`` at the flagship widths (``MODELS``), COCO
    vocab, 36 x 2048 features, max length 20."""
    return SimpleNamespace(caption_model=model, vocab_size=V,
                           fc_feat_size=FEAT, att_feat_size=FEAT,
                           max_length=20, compute_dtype=dtype_name,
                           **MODELS[model])


def coco_vocab():
    """A COCO-sized vocab whose last entry is UNK and every fourth word a
    function word (``remove_bad_endings`` bans them before EOS)."""
    from ..models.harness import BAD_ENDINGS
    vocab = {str(i): BAD_ENDINGS[i // 4 % len(BAD_ENDINGS)] if i % 4 == 0
             else 'w%d' % i for i in range(1, V + 1)}
    vocab[str(V)] = 'UNK'
    return vocab


def make_captioner(model: str, dtype_name: str, device: str, seed: int = 0):
    """A ``Captioner`` at the flagship widths, its weights from the port's
    own init with a seeded generator, over ``coco_vocab``."""
    from ..models.api import setup
    return setup(model_opt(model, dtype_name), coco_vocab(),
                 device).init_params(torch.Generator().manual_seed(seed))


def features(B: int, device: str, seed: int):
    """36 x 2048 region features and their mean as the fc feature, as the
    bottom-up features give them."""
    g = torch.Generator().manual_seed(seed)
    att = torch.randn(B, REGIONS, FEAT, generator=g).to(device)
    return att.mean(1), att, torch.ones(B, REGIONS, device=device)


def decode(cap, mode: str, fc, att, am, rng=None, graphed=False):
    """(seq, {'ent_sum', 'lp_sum'}) of one ``MODES`` decode through the
    entry point a user calls (``graphed``: the CUDA-graph entry, beam and
    stats modes only); the table modes' sums are taken from the tables (a
    diverse sample's from its sampled logprobs, entropy 0, as
    ``eval_split`` takes them).  ``rng``: the sampling noise (a generator
    on the device, a ``draw`` callable, or None for seed 0)."""
    kind, opt, _ = MODES[mode]
    if graphed and kind not in ('beam', 'stats'):
        raise ValueError('mode %s has no graph route' % mode)
    if kind == 'beam':
        entry = cap.sample_beam_graphed if graphed else cap.sample_beam
        seq, stats, _ = entry(fc, att, am, rng, opt)
        return seq, stats
    if kind == 'stats':
        entry = cap.sample_stats_graphed if graphed else cap.sample_stats
        return entry(fc, att, am, rng, opt)
    if kind == 'replay':
        seq, lp, _ = cap.sample_beam(fc, att, am, rng, opt, want_logps=True)
    else:
        seq, lp = cap.sample(fc, att, am, rng, opt)
    if lp.dim() == 3:
        return seq, {'ent_sum': -(lp.exp() * lp).sum((1, 2)),
                     'lp_sum': lp.gather(2, seq[..., None]).sum((1, 2))}
    # a step counts while no earlier token ended the row
    keep = torch.cat([torch.ones_like(seq[:, :1]),
                      (seq[:, :-1] > 0).long().cumprod(1)], 1).bool()
    return seq, {'ent_sum': torch.zeros_like(lp[:, 0]),
                 'lp_sum': torch.where(keep, lp, 0.0).sum(1)}


def profiled(cap, mode, fc, att, am, graphed):
    """One profiled batch: its wall, device busy, idle share and top
    kernels."""
    return profile_call(lambda: decode(cap, mode, fc, att, am,
                                       graphed=graphed))


def profile_call(fn):
    """``profiled`` of one call of ``fn``, whatever it runs on the
    card."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = 1000 * (time.time() - t)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1000
    events.sort(key=lambda e: -e.self_device_time_total)
    return {'wall_ms_profiled': wall, 'device_busy_ms': busy,
            'idle_share': 1 - busy / wall,
            'kernels': [{'name': e.key[:90], 'calls': e.count,
                         'ms': e.self_device_time_total / 1000,
                         'share': e.self_device_time_total / 1000 / busy}
                        for e in events[:TOP]]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--model', default='transformer', choices=sorted(MODELS))
    p.add_argument('--mode', default='beam5', choices=sorted(MODES))
    p.add_argument('--route', default='eager',
                   choices=('eager', 'graph', 'both'))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_decode: needs a CUDA device')
    routes = {'eager': [False], 'graph': [True],
              'both': [False, True]}[a.route]
    cap = make_captioner(a.model, 'bfloat16', 'cuda')
    fc, att, am = features(BATCH, 'cuda', seed=1)
    for graphed in routes:                  # warm-up; the graphs' capture
        decode(cap, a.mode, fc, att, am, graphed=graphed)
    torch.cuda.synchronize()
    walls = {g: [] for g in routes}
    for i in range(WALLS):
        for graphed in routes if i % 2 == 0 else routes[::-1]:
            t = time.time()
            decode(cap, a.mode, fc, att, am, graphed=graphed)
            torch.cuda.synchronize()
            walls[graphed].append(1000 * (time.time() - t))
    out = {'model': a.model, 'mode': a.mode, 'batch': BATCH,
           'device': torch.cuda.get_device_name(0), 'routes': {}}
    for graphed in routes:
        name = 'graph' if graphed else 'eager'
        out['routes'][name] = dict(wall_ms_unprofiled=walls[graphed],
                                   **profiled(cap, a.mode, fc, att, am,
                                              graphed))
    if cap._graph_cache:
        out['graph_cache'] = [{'capture_s': e.capture_s,
                               'bytes_allocated': e.bytes_allocated,
                               'bytes_reserved': e.bytes_reserved,
                               'held': e.held()}
                              for e in cap._graph_cache.values()]
    print(json.dumps(out, indent=1))
    return out


if __name__ == '__main__':
    main()
