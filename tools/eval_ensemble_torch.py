"""Ensemble evaluation of the PyTorch port (counterpart of
tools/eval_ensemble.py).

Builds a ``models.ensemble.EnsembleCaptioner`` from the
``log_<id>/infos_<id>[-app].pkl`` + ``log_<id>/model[-app].npz``
checkpoints of ``--ids`` (JAX-trained or written by tools/train_torch.py),
averages the members' probabilities by ``--weights`` and evaluates with
``captioning_tpu_torch.utils.eval_utils.eval_split`` on ``--device`` (cuda
by default; ``--device cpu`` runs the kernels' plain twins).  With
``--device cuda`` and no GPU it raises.  ``--device_mesh 1`` and the
``--dist_*`` options start or join a group of one rank a GPU that decodes
each batch cooperatively, as in ``tools/eval_torch.py``.

    python tools/eval_ensemble_torch.py --ids trans-best trans_nsc-best \\
        --beam_size 5 --split test --language_eval 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import torch  # noqa: E402

import captioning_tpu_torch.utils.misc as utils  # noqa: E402
import captioning_tpu_torch.utils.opts as opts  # noqa: E402
from captioning_tpu_torch.models.api import setup  # noqa: E402
from captioning_tpu_torch.models.ensemble import EnsembleCaptioner  # noqa
from captioning_tpu_torch.parallel import launch, mesh  # noqa: E402
from captioning_tpu_torch.utils import eval_utils  # noqa: E402


def main(argv=None, n_devices=None):
    """``n_devices`` stands in for the visible GPUs of ``--device_mesh 1``
    (``launch.eval_ranks_to_start``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--ids', nargs='+', required=True,
                        help='ids of the models to ensemble')
    parser.add_argument('--weights', nargs='+', required=False, default=None)
    parser.add_argument('--cnn_model', type=str, default='resnet101')
    parser.add_argument('--device', type=str, default='cuda',
                        choices=('cuda', 'cpu'))
    opts.add_eval_options(parser)
    opts.add_diversity_opts(parser)
    opts.add_dist_options(parser)
    opt = parser.parse_args(argv)
    if opt.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run the plain twins)')

    launch.run_eval(os.path.abspath(__file__),
                    sys.argv[1:] if argv is None else argv, opt,
                    lambda device: _evaluate(opt, device), n_devices)


def _evaluate(opt, device):
    """Decode and score on ``device``: one process, or a rank of the eval
    group (the data axis over the whole group)."""
    is_main = mesh.make_mesh('').rank == 0
    model_infos = []
    model_paths = []
    for mid in opt.ids:
        if '-' in mid:
            mid, app = mid.split('-')
            app = '-' + app
        else:
            app = ''
        with open('log_%s/infos_%s%s.pkl' % (mid, mid, app), 'rb') as f:
            model_infos.append(utils.pickle_load(f))
        model_paths.append('log_%s/model%s.npz' % (mid, app))

    infos = model_infos[0]
    replace = ['input_fc_dir', 'input_att_dir', 'input_box_dir',
               'input_label_h5', 'input_json', 'batch_size', 'id']
    for k in replace:
        setattr(opt, k, getattr(opt, k) or getattr(infos['opt'], k, ''))
    vars(opt).update({k: vars(infos['opt'])[k]
                      for k in vars(infos['opt']).keys()
                      if k not in vars(opt)})
    opt.use_box = max(getattr(i['opt'], 'use_box', 0) for i in model_infos)

    vocab = infos['vocab']

    captioners = []
    for i in range(len(model_infos)):
        model_infos[i]['opt'].start_from = None
        model_infos[i]['opt'].vocab_size = len(vocab)
        captioners.append(setup(model_infos[i]['opt'], vocab,
                                device=device).load_params(
                                    model_paths[i]))

    weights = ([float(w) for w in opt.weights]
               if opt.weights is not None else None)
    ensemble = EnsembleCaptioner(captioners, weights)

    from captioning_tpu_torch.data.dataset import DataLoader
    loader = DataLoader(opt)
    loader.dataset.ix_to_word = vocab

    opt.id = '+'.join(
        [a + str(b) for a, b in zip(
            opt.ids, weights or [1.0] * len(opt.ids))])
    opt.dataset = opt.input_json

    loss, split_predictions, lang_stats = eval_utils.eval_split(
        ensemble, loader, vars(opt))

    if not is_main:
        return
    print('loss: ', loss)
    if lang_stats:
        print(lang_stats)

    if opt.dump_json == 1:
        os.makedirs('vis', exist_ok=True)
        with open('vis/vis.json', 'w') as f:
            json.dump(split_predictions, f)


if __name__ == '__main__':
    main()
