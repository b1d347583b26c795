"""Profile one eval-decode batch of a full-width captioner on the GPU with
``torch.profiler``: wall, device busy, idle share and the kernels that
take the device time.

    python -m captioning_tpu_torch.tools.profile_decode \\
        [--model transformer|updown|stackatt|newfc] [--mode beam5|greedy]

The model is built at the flagship widths (``MODELS``: the transformer of
``configs/transformer/transformer.yml``, UpDown of
``configs/updown/updown.yml``, StackAtt at the ``opts.py`` widths, NewFC
of ``configs/fc.yml``; COCO vocab 9487 + 1, 36 x 2048 features, max
length 20, bf16, B = 1024) with random weights from a seed, as
``chip_smoke.py`` builds it.  One warm-up batch, 3 unprofiled batches
(host clock ending in a synchronize), then one profiled batch.  Device
busy is the sum of the self device time of the profiler's device events
(each kernel once); idle share = 1 - busy / the profiled batch's wall.
The profiler slows a host-bound decode, so both walls are printed, and
the 15 kernels that take the most device time.
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
# configs/fc.yml (MODEL_ZOO row "FC", the opts.py widths)
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
}
BEAM = {'beam_size': 5, 'sample_n': 1, 'group_size': 1, 'suppress_UNK': 1}
GREEDY = {'sample_method': 'greedy', 'beam_size': 1, 'sample_n': 1}


def make_captioner(model: str, dtype_name: str, device: str, seed: int = 0):
    """A ``Captioner`` at the flagship widths, its weights from the port's
    own init with a seeded generator; the COCO vocab's last entry is
    UNK."""
    from ..models.api import setup
    opt = SimpleNamespace(caption_model=model, vocab_size=V,
                          fc_feat_size=FEAT, att_feat_size=FEAT,
                          max_length=20, compute_dtype=dtype_name,
                          **MODELS[model])
    vocab = {str(i): 'w%d' % i for i in range(1, V + 1)}
    vocab[str(V)] = 'UNK'
    return setup(opt, vocab, device).init_params(
        torch.Generator().manual_seed(seed))


def features(B: int, device: str, seed: int):
    """36 x 2048 region features and their mean as the fc feature, as the
    bottom-up features give them."""
    g = torch.Generator().manual_seed(seed)
    att = torch.randn(B, REGIONS, FEAT, generator=g).to(device)
    return att.mean(1), att, torch.ones(B, REGIONS, device=device)


def decode(cap, mode: str, fc, att, am):
    if mode == 'beam5':
        seq, stats, _ = cap.sample_beam(fc, att, am, None, BEAM)
    else:
        seq, stats = cap.sample_stats(fc, att, am, None, GREEDY)
    return seq, stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--model', default='transformer', choices=sorted(MODELS))
    p.add_argument('--mode', default='beam5', choices=('beam5', 'greedy'))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_decode: needs a CUDA device')
    from torch.profiler import ProfilerActivity, profile
    cap = make_captioner(a.model, 'bfloat16', 'cuda')
    fc, att, am = features(BATCH, 'cuda', seed=1)
    decode(cap, a.mode, fc, att, am)                       # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(WALLS):
        t = time.time()
        decode(cap, a.mode, fc, att, am)
        torch.cuda.synchronize()
        walls.append(1000 * (time.time() - t))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        decode(cap, a.mode, fc, att, am)
        torch.cuda.synchronize()
        wall = 1000 * (time.time() - t)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1000
    events.sort(key=lambda e: -e.self_device_time_total)
    out = {'model': a.model, 'mode': a.mode, 'batch': BATCH,
           'device': torch.cuda.get_device_name(0),
           'wall_ms_unprofiled': walls, 'wall_ms_profiled': wall,
           'device_busy_ms': busy, 'idle_share': 1 - busy / wall,
           'kernels': [{'name': e.key[:90], 'calls': e.count,
                        'ms': e.self_device_time_total / 1000,
                        'share': e.self_device_time_total / 1000 / busy}
                       for e in events[:TOP]]}
    print(json.dumps(out, indent=1))
    return out


if __name__ == '__main__':
    main()
