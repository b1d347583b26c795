"""The eval loop: ``utils/eval_utils.eval_split`` of the program over one
split, passes back to back, closed loop, one client.

Set-up: the weights (``weights.make``) through the checkpoint path
(``Captioner.load_jax_variables``), the split's features in host memory
(``data.features``), and one warm pass, which captures the graph decode
of the split's batch shape; nothing else is warmed.  The window then runs
whole passes until one crosses ``--seconds``: ``work`` is the captions
they returned, ``marks`` the loader's ``get_batch`` calls (each a
batch's completion) and the window's end; every decode call is timed
(``spans['decode']``, a wrapper around the captioner's graph decode
entry), read by a ``--trace 1`` run, which after the window also
profiles one more pass (``trace.py``).  The traffic's ``eval_kwargs`` are
``eval_split``'s options.

``correct``: the traffic's check (``checks/<check>.py``) judges a sample
of the window's captions, drawn from the seed, against the plain
reference once the program's state is freed.
"""

from __future__ import annotations

import gc
import random
import time
from types import SimpleNamespace

import numpy as np

from perfbench import data, weights


class Timed:
    """The captioner as ``eval_split`` sees it, its graph decode entry
    timed: each call's host wall (the entry returns once the decode has
    run: it reads the exit flag after every step) is appended to
    ``spans``."""

    def __init__(self, captioner, spans):
        self._captioner = captioner
        self._spans = spans

    def __getattr__(self, name):
        return getattr(self._captioner, name)

    def sample_beam_graphed(self, *args, **kw):
        t = time.perf_counter()
        out = self._captioner.sample_beam_graphed(*args, **kw)
        self._spans.append(time.perf_counter() - t)
        return out


def _replays(captioner):
    """{graph decode: [replays of each of its graphs]}."""
    return {key: list(e.replays) for key, e in
            captioner._graph_cache.items()}


def _graph_work(h, captioner, before, after):
    """(model FLOPs, {kernel wrapper: [(shape, launches)]}) of the graph
    replays between two ``_replays`` snapshots."""
    flops_mod = h.cell.flops()
    opt, bdash = h.options, int(h.traffic['eval_kwargs']['beam_size'])
    M = h.cell.config['features']['regions']
    flops, launches = 0.0, {}
    for key, entry in captioner._graph_cache.items():
        B = entry.inputs[1].shape[0]
        old = before.get(key, [0] * len(entry.replays))
        for g, (n1, n0) in enumerate(zip(after[key], old)):
            n = n1 - n0
            if not n:
                continue
            flops += n * flops_mod.beam_flops(opt, M, B, bdash, g)
            shapes = flops_mod.beam_launches(opt, M, B, bdash, g)
            for name, calls in entry.captured[g].items():
                launches.setdefault(name, []).append(
                    (shapes.get(name), calls * n))
    return flops, launches


def _sample_images(seed, n, k):
    """The images a run of ``seed`` judges, and its random stream (which
    then draws the pass of each)."""
    rng = random.Random(seed)
    return sorted(rng.sample(range(n), min(k, n))), rng


def control_sample(h):
    """(weights on the device, the sample) of the images a run of
    ``h.seed`` judges, without the program: the control's input."""
    opt, tr = h.options, h.traffic
    n = int(tr['images'])
    feat = h.cell.config['features']
    fc, att, am = data.features(n, feat['regions'], opt['att_feat_size'],
                                feat['use_fc'], h.seed, h.device)
    images, _ = _sample_images(h.seed, n, int(tr['check_images']))
    layout = h.cell.reference().layout(opt, h.cell.config['init'])
    wdev, _ = weights.make(layout, h.seed, h.device)
    return wdev, ({'images': np.array(images), 'fc': fc[images],
                   'att': att[images], 'am': am[images]},), {}


def run(h):
    from captioning_tpu_torch.models.api import setup
    from captioning_tpu_torch.utils import eval_utils
    opt, tr, dev = h.options, h.traffic, h.device
    V, L = opt['vocab_size'], opt['max_length']
    feat_cfg = h.cell.config['features']
    layout = h.cell.reference().layout(opt, h.cell.config['init'])
    wdev, whost = weights.make(layout, h.seed, dev)
    vocab = data.vocab(V)
    cap = setup(SimpleNamespace(**opt), vocab, dev).load_jax_variables(whost)
    del whost
    n, batch = int(tr['images']), int(tr['batch_size'])
    fc, att, am = data.features(n, feat_cfg['regions'],
                                opt['att_feat_size'], feat_cfg['use_fc'],
                                h.seed, dev)
    loader = data.SplitLoader(fc, att, am, vocab, batch)
    spans = []
    entry = Timed(cap, spans)
    kw = dict(tr['eval_kwargs'], num_images=n, id='perfbench',
              split='test', seed=0)

    eval_utils.eval_split(entry, loader, kw)          # the warm pass
    h.sync()
    # the check's images, drawn from the seed; a pass's other answers go
    # as they would in a user's loop
    images, rng = _sample_images(h.seed, n, int(tr['check_images']))
    before = _replays(cap)
    spans.clear()
    loader.recording = True
    t0 = time.perf_counter()
    setup_s = time.time() - h.T0
    kept, returned = [], []
    while True:
        preds = eval_utils.eval_split(entry, loader, kw)[1]
        kept.append([preds[i] for i in images])
        returned.append(len(preds))
        del preds
        if time.perf_counter() - t0 >= h.seconds:
            break
    h.sync()
    t1 = time.perf_counter()
    loader.recording = False
    flops, _ = _graph_work(h, cap, before, _replays(cap))
    rec = {'setup_s': setup_s, 'window_s': t1 - t0, 'kind': 'eval',
           'work': float(sum(returned)), 'marks': loader.marks + [t1],
           'flops': flops, 'spans': {'decode': list(spans)},
           'attempted': n * len(kept),
           'failed': sum(max(n - r, 0) for r in returned)}
    rec['memory_peak_bytes'] = h.memory_peak()

    if h.trace:
        before = _replays(cap)
        _, tr_rec = h.profile(lambda: eval_utils.eval_split(entry, loader,
                                                            kw))
        _, launches = _graph_work(h, cap, before, _replays(cap))
        tr_rec['batches'] = -(-n // batch)
        tr_rec['launches'] = launches
        rec['trace'] = tr_rec

    # the sample the check judges: a pass of each image, drawn from the seed
    served = [kept[rng.randrange(len(kept))][j] for j in range(len(images))]
    images = np.array([e['image_id'] for e in served])
    sample = {'images': images,
              'tokens': data.tokens([e['caption'] for e in served], V, L),
              'perplexity': np.array([e['perplexity'] for e in served]),
              'entropy': np.array([e['entropy'] for e in served]),
              'fc': fc[images], 'att': att[images], 'am': am[images]}
    del cap, entry, loader, kept, fc, att, am
    gc.collect()
    h.empty_cache()
    rec['check'] = h.cell.check().judge(h, wdev, sample)
    return rec
