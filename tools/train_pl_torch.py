"""The Lightning entry point of the PyTorch port (counterpart of
tools/train_pl.py, reference tools/train_pl.py).

The reference's Lightning script trains DDP over every visible GPU
(``devices=torch.cuda.device_count()``, reference train_pl.py:479-480).
Here that is tools/train_torch.py with a data axis over every visible GPU,
one process each (``--mesh_shape data:<GPU count>`` unless the options
name a mesh or a group; one GPU, or ``--device cpu``: one process).
``--batch_size`` is global, as in tools/train_torch.py.

``EVALUATE=1`` evaluates instead of training (reference
train_pl.py:494-497): tools/eval_torch.py on the test split, from
``model-best.npz`` (else ``model.npz``) and its infos in
``--checkpoint_path``.

    python tools/train_pl_torch.py --cfg configs/updown/updown.yml --id up
    EVALUATE=1 python tools/train_pl_torch.py --cfg ... --id up
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import torch  # noqa: E402

import captioning_tpu_torch.utils.opts as opts  # noqa: E402


def _checkpoint(opt):
    """(model, infos) to evaluate: the -best pair where it exists."""
    ckpt = os.path.join(opt.checkpoint_path, 'model-best.npz')
    if not os.path.exists(ckpt):
        ckpt = os.path.join(opt.checkpoint_path, 'model.npz')
    infos = os.path.join(opt.checkpoint_path, 'infos_' + opt.id + '-best.pkl')
    if not os.path.exists(infos):
        infos = os.path.join(opt.checkpoint_path, 'infos_' + opt.id + '.pkl')
    return ckpt, infos


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--device', type=str, default='cuda',
                     choices=('cuda', 'cpu'))
    known, rest = pre.parse_known_args(argv)
    opt = opts.parse_opt(rest)

    if os.environ.get('EVALUATE', '0') == '1':
        from tools import eval_torch
        ckpt, infos = _checkpoint(opt)
        eval_torch.main(['--device', known.device, '--model', ckpt,
                         '--infos_path', infos, '--split', 'test',
                         '--language_eval', str(opt.language_eval),
                         '--beam_size', str(max(1, opt.beam_size))])
        return

    from tools import train_torch
    n_gpus = (torch.cuda.device_count() if known.device == 'cuda' else 0)
    if n_gpus > 1 and not (opt.mesh_shape or opt.dist_coordinator or
                           opt.dist_auto):
        rest = rest + ['--mesh_shape', 'data:%d' % n_gpus]
    train_torch.main(['--device', known.device] + rest)


if __name__ == '__main__':
    main()
