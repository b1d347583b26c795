"""Profile XE train steps of a full-width captioner on the GPU with
``torch.profiler``: the step's wall, device busy, idle share and the
kernels that take the device time.

    python -m captioning_tpu_torch.tools.profile_train \\
        [--model updown|stackatt|transformer]

The model is built at the flagship widths of ``profile_decode.MODELS`` in
float32 from the port's seeded init, and trained with its config's
options (``TRAIN``: UpDown of ``configs/updown/updown.yml`` and StackAtt
at adam 5e-4, the scheduled-sampling ramp's maximum 0.25 and the
``opts.py`` dropout 0.5; the transformer of
``configs/transformer/transformer.yml`` with noam, warmup 20000, dropout
0.1; clip by value 0.1) on one seeded batch of 10 images x 5 captions of
label length 16, as ``chip_smoke.py`` phase 9 trains them.  3 warm-up
steps, 5 unprofiled steps (host clock ending in a synchronize), then 3
profiled steps.  Device busy is the sum of the self device time of the
profiler's device events, user annotations (the optimizer's step range)
left out since they span kernels counted already; idle share = 1 - busy /
the profiled steps' wall.  Prints JSON.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

from . import profile_decode as pd
from ..utils.optimizers import noam_rate

L = 16                          # COCO's label length
WARM, WALLS, PROFILED, TOP = 3, 5, 3, 15
# per model: the captioner's option overrides, the trainer's, ss_prob and
# the learning rate at iteration it (1-based)
TRAIN = {
    'updown': ({'drop_prob_lm': 0.5}, {}, 0.25, lambda it: 5e-4),
    'stackatt': ({'drop_prob_lm': 0.5}, {}, 0.25, lambda it: 5e-4),
    # drop_prob_lm (the att embed's) keeps its opts.py 0.5
    'transformer': ({'drop_prob_lm': 0.5, 'dropout': 0.1},
                    {'noamopt': True, 'noamopt_warmup': 20000}, 0.0,
                    lambda it: noam_rate(it, 512, 1.0, 20000)),
}


def train_captioner(model: str, device: str, **kw):
    """A float32 ``Captioner`` at the flagship widths, with ``kw``
    overriding its options, from the port's init with a seeded
    generator."""
    from ..models.api import setup
    opt = SimpleNamespace(caption_model=model, vocab_size=pd.V,
                          fc_feat_size=pd.FEAT, att_feat_size=pd.FEAT,
                          max_length=20, compute_dtype='float32',
                          **dict(pd.MODELS[model], **kw))
    vocab = {str(i): 'w%d' % i for i in range(1, pd.V + 1)}
    return setup(opt, vocab, device).init_params(
        torch.Generator().manual_seed(0))


def train_opt(**kw):
    """The XE trainer's options: the configs' adam 5e-4, the opts.py clip
    by value 0.1, no weight decay, label smoothing or drop-worst."""
    return SimpleNamespace(**dict(dict(
        optim='adam', learning_rate=5e-4, optim_alpha=0.9, optim_beta=0.999,
        optim_epsilon=1e-8, weight_decay=0.0, grad_clip_mode='value',
        grad_clip_value=0.1, noamopt=False, label_smoothing=0.0,
        drop_worst_rate=0.0), **kw))


def train_batch(B: int, seed: int):
    """fc, att, att_masks, labels, masks of B images x 5 captions of
    8..L tokens, laid out as the loader gives them (a BOS column, a
    trailing 0), on the CPU."""
    fc, att, am = pd.features(B, 'cpu', seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    lengths = torch.randint(8, L + 1, (B, 5), generator=g)
    tok = torch.randint(1, pd.V + 1, (B, 5, L), generator=g)
    labels = torch.zeros(B, 5, L + 2, dtype=torch.long)
    labels[..., 1:L + 1] = torch.where(torch.arange(L) < lengths[..., None],
                                       tok, 0)
    masks = (torch.arange(L + 2) <= lengths[..., None] + 1).float()
    return fc, att, am, labels, masks


def make_step(model: str, device: str = 'cuda', B: int = 10):
    """(trainer, step(it) -> loss tensor, the dropout generator) for
    ``model`` trained with its ``TRAIN`` options on one seeded batch."""
    from ..modules.trainer import Trainer
    model_kw, opt_kw, ss_prob, lr_fn = TRAIN[model]
    tr = Trainer(train_captioner(model, device, **model_kw),
                 train_opt(**opt_kw))
    fc, att, am, labels, masks = (x.to(device) for x in train_batch(B, 4))
    gen = torch.Generator(device).manual_seed(6)

    def step(it):
        return tr.xe_step(fc, att, labels, masks, am, lr_fn(it), ss_prob,
                          gen)['loss']

    return tr, step, gen


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--model', default='updown', choices=sorted(TRAIN))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: needs a CUDA device')
    from torch.profiler import ProfilerActivity, profile
    _, step, _ = make_step(a.model)
    it = 0
    for _ in range(WARM):
        it += 1
        step(it)
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALLS):
        it += 1
        t = time.time()
        step(it)
        torch.cuda.synchronize()
        walls.append(1000 * (time.time() - t))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        for _ in range(PROFILED):
            it += 1
            step(it)
        torch.cuda.synchronize()
        wall = 1000 * (time.time() - t) / PROFILED
    # device events of kernels and copies; the optimizer's step is also a
    # user annotation mirrored on the device, over kernels already counted
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    busy = sum(e.self_device_time_total for e in events) / 1000 / PROFILED
    events.sort(key=lambda e: -e.self_device_time_total)
    out = {'model': a.model, 'batch': '10 x 5', 'label_length': L,
           'device': torch.cuda.get_device_name(0),
           'step_wall_ms_unprofiled': walls,
           'step_wall_ms_profiled': wall, 'device_busy_ms': busy,
           'idle_share': 1 - busy / wall,
           'kernels': [{'name': e.key[:90], 'calls': e.count // PROFILED,
                        'ms': e.self_device_time_total / 1000 / PROFILED,
                        'share': e.self_device_time_total / 1000 / PROFILED
                        / busy}
                       for e in events[:TOP]]}
    print(json.dumps(out, indent=1))
    return out


if __name__ == '__main__':
    main()
