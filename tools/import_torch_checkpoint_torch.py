"""Import a reference PyTorch checkpoint into a run directory of the port
(counterpart of tools/import_torch_checkpoint.py).

    python tools/import_torch_checkpoint_torch.py \
        --infos_path log_x/infos_x.pkl --model log_x/model.pth \
        --output_dir log_x_port --id x

Converts the upstream ``state_dict`` with the port's copy of the
converter (``captioning_tpu_torch/utils/torch_convert.py``) for the config
of the infos' options (``captioning_tpu_torch/models/config.py``), and
writes ``model.npz`` + a compatible ``infos_<id>.pkl`` (its
``loader_state_dict`` cleared: the torch sampler state is not portable),
so tools/eval_torch.py (``--model``) and tools/train_torch.py
(``--start_from``) read the directory directly, as tools/eval.py and
tools/train.py do.  Runs on the CPU: it builds no model and launches
nothing on a card.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import captioning_tpu_torch.utils.misc as utils  # noqa: E402
from captioning_tpu_torch.models.config import config_from_opt  # noqa: E402
from captioning_tpu_torch.utils.torch_convert import (  # noqa: E402
    convert_checkpoint)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--infos_path', required=True)
    parser.add_argument('--model', required=True, help='torch model.pth')
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--id', default=None)
    args = parser.parse_args(argv)

    with open(args.infos_path, 'rb') as f:
        infos = utils.pickle_load(f)
    opt = infos['opt']
    run_id = args.id if args.id is not None else getattr(opt, 'id', '')

    cfg = config_from_opt(opt, len(infos['vocab']))
    variables = convert_checkpoint(args.model, cfg)

    os.makedirs(args.output_dir, exist_ok=True)
    utils.save_pytree(variables, os.path.join(args.output_dir, 'model.npz'))
    infos['loader_state_dict'] = None  # torch sampler state is not portable
    with open(os.path.join(args.output_dir, 'infos_%s.pkl' % run_id),
              'wb') as f:
        utils.pickle_dump(infos, f)
    print('wrote', args.output_dir, '(model.npz, infos_%s.pkl)' % run_id)


if __name__ == '__main__':
    main()
