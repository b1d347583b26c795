"""Evaluation entry point of the PyTorch port (counterpart of tools/eval.py).

Reads a JAX-trained checkpoint (``model.npz`` + the infos pickle), overlays
the eval options on the training opts exactly as tools/eval.py does, and
evaluates with ``captioning_tpu_torch.utils.eval_utils.eval_split`` on
``--device`` (cuda by default; the CUDA kernels build at first use;
``--device cpu`` runs the kernels' plain twins).  With ``--device cuda``
and no GPU it raises: it never carries on on the CPU.  Every
``caption_model`` key of the JAX package is ported (the transformer,
bert, m2transformer, aoa and the RNN captioners).  Every decode option of
tools/eval.py
reaches the decode: beam search with diverse groups (``--group_size``,
``--diversity_lambda``), the constraints, the sample methods, and
``--sample_n`` captions an image by ``--sample_n_method`` (``bs``,
``sample``, ``gumbel``, ``top<k>``, ``top<p>``, ``dbs``, ``d<method>``)
scored with the diversity metrics.  The options, the data loader and the
metrics are the port's own copies of the JAX package's host-only modules
(``captioning_tpu_torch/utils``, ``captioning_tpu_torch/data``).
``--image_folder`` captions a folder of raw images (or the ``--coco_json``
list in it): ``data/dataloaderraw.DataLoaderRaw`` runs the ResNet
``--cnn_model`` of ``./data/imagenet_weights/<cnn_model>.pth`` (a
torchvision ``state_dict``) on ``--device`` for each image's features.
``--device_mesh 1`` on a host with several GPUs starts one rank process a
GPU (``parallel/launch.py``), which decode each batch cooperatively
(``eval_split``: the batch padded to a multiple of the ranks, the pads
dropped); rank 0 alone prints, writes ``eval_results/`` and dumps the
JSON.  One GPU or ``--device cpu``: one process, as without it.  A
process of a group started otherwise (``--dist_coordinator`` /
``--dist_auto 1``, as ``tools/train_torch.py`` takes them) evaluates as
that group's rank.

    python tools/eval_torch.py --model log/model-best.npz \\
        --infos_path log/infos_<id>-best.pkl --beam_size 5 --split test
    python tools/eval_torch.py --model log/model-best.npz \\
        --infos_path log/infos_<id>-best.pkl --beam_size 1 --sample_n 5 \\
        --sample_n_method top0.9 --language_eval 1 --split test
    python tools/eval_torch.py --model log/model-best.npz \
        --infos_path log/infos_<id>-best.pkl --image_folder photos \
        --beam_size 5 --batch_size 16
    python tools/eval_torch.py --model log/model-best.npz \
        --infos_path log/infos_<id>-best.pkl --beam_size 5 --device_mesh 1
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import torch  # noqa: E402

import captioning_tpu_torch.utils.misc as utils  # noqa: E402
import captioning_tpu_torch.utils.opts as opts  # noqa: E402
from captioning_tpu_torch.models.api import setup  # noqa: E402
from captioning_tpu_torch.parallel import launch, mesh  # noqa: E402
from captioning_tpu_torch.utils import eval_utils  # noqa: E402


def main(argv=None, n_devices=None):
    """``n_devices`` stands in for the visible GPUs of ``--device_mesh 1``
    (``launch.eval_ranks_to_start``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', type=str, default='',
                        help='path to model .npz to evaluate')
    parser.add_argument('--cnn_model', type=str, default='resnet101')
    parser.add_argument('--infos_path', type=str, default='',
                        help='path to infos pkl to evaluate')
    parser.add_argument('--only_lang_eval', type=int, default=0)
    parser.add_argument('--annfile', type=str, default='',
                        help='explicit coco-format annotations json for '
                             'language eval')
    parser.add_argument('--force', type=int, default=0)
    parser.add_argument('--device', type=str, default='cuda',
                        choices=('cuda', 'cpu'))
    opts.add_eval_options(parser)
    opts.add_diversity_opts(parser)
    opts.add_dist_options(parser)
    opt = parser.parse_args(argv)
    if opt.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(pass --device cpu to run the plain twins)')

    with open(opt.infos_path, 'rb') as f:
        infos = utils.pickle_load(f)

    # override and collect parameters (reference eval.py:46-54)
    replace = ['input_fc_dir', 'input_att_dir', 'input_box_dir',
               'input_label_h5', 'input_json', 'batch_size', 'id']
    ignore = ['start_from']
    for k in vars(infos['opt']).keys():
        if k in replace:
            setattr(opt, k, getattr(opt, k) or getattr(infos['opt'], k, ''))
        elif k not in ignore:
            if k not in vars(opt):
                vars(opt).update({k: vars(infos['opt'])[k]})

    pred_fn = os.path.join('eval_results/', '.saved_pred_' + opt.id + '_' +
                           opt.split + '.pkl')
    result_fn = os.path.join('eval_results/', opt.id + '_' + opt.split +
                             '.json')

    if opt.only_lang_eval == 1 or (not opt.force and os.path.isfile(pred_fn)):
        if not opt.force and os.path.isfile(result_fn):
            try:
                with open(result_fn) as f:
                    json.load(f)
                print('already evaluated')
                return
            except ValueError:
                pass
        with open(pred_fn, 'rb') as f:
            predictions, n_predictions = pickle.load(f)
        print(eval_utils.language_eval(opt.annfile or opt.input_json,
                                       predictions, n_predictions, vars(opt),
                                       opt.split))
        return

    launch.run_eval(os.path.abspath(__file__),
                    sys.argv[1:] if argv is None else argv, opt,
                    lambda device: _evaluate(opt, infos, device), n_devices)


def _evaluate(opt, infos, device):
    """Decode and score on ``device``: one process, or a rank of the eval
    group (the data axis over the whole group)."""
    is_main = mesh.make_mesh('').rank == 0
    vocab = infos['vocab']
    opt.vocab_size = len(vocab)
    captioner = setup(opt, vocab, device=device).load_params(opt.model)

    if len(opt.image_folder) == 0:
        from captioning_tpu_torch.data.dataset import DataLoader
        loader = DataLoader(opt)
    else:
        from captioning_tpu_torch.data.dataloaderraw import DataLoaderRaw
        loader = DataLoaderRaw({'folder_path': opt.image_folder,
                                'coco_json': opt.coco_json,
                                'batch_size': opt.batch_size,
                                'cnn_model': opt.cnn_model,
                                'device': device})
    # the vocab of the infos file (reference eval.py:109-111)
    loader.dataset.ix_to_word = infos['vocab']

    opt.dataset = opt.annfile or opt.input_json
    loss, split_predictions, lang_stats = eval_utils.eval_split(
        captioner, loader, vars(opt))
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
