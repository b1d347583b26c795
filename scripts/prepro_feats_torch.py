"""Extract ResNet fc + att features for every image (the PyTorch port's
counterpart of scripts/prepro_feats.py).

ImageNet-normalised full-size images through the stride-tweaked ResNet of
``captioning_tpu_torch/models/resnet.py`` on ``--device`` (cuda by
default), writing per-image ``<output_dir>_fc/<cocoid>.npy`` (fc, 2048)
and ``<output_dir>_att/<cocoid>.npz`` (key ``feat``: att_size x att_size x
2048).  Needs a torchvision checkpoint at ``<model_root>/<model>.pth``
(nothing is downloaded).

    python scripts/prepro_feats_torch.py --input_json data/dataset_coco.json \\
        --output_dir data/cocotalk --images_root data/images
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from random import seed

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main(params):
    from captioning_tpu_torch.models.resnet import load_resnet, \
        resnet_features

    weights = os.path.join(params['model_root'], params['model'] + '.pth')
    model = load_resnet(weights, params['model'], params['device'])

    with open(params['input_json'], 'r') as f:
        imgs = json.load(f)['images']
    N = len(imgs)
    seed(123)

    dir_fc = params['output_dir'] + '_fc'
    dir_att = params['output_dir'] + '_att'
    os.makedirs(dir_fc, exist_ok=True)
    os.makedirs(dir_att, exist_ok=True)

    from PIL import Image
    for i, img in enumerate(imgs):
        path = os.path.join(params['images_root'], img.get('filepath', ''),
                            img['filename'])
        with Image.open(path) as im:
            arr = np.asarray(im.convert('RGB')).astype('float32') / 255.0
        fc, att = resnet_features(model, arr, params['att_size'])
        np.save(os.path.join(dir_fc, str(img['cocoid'])), fc.cpu().numpy())
        np.savez_compressed(os.path.join(dir_att, str(img['cocoid'])),
                            feat=att.cpu().numpy())
        if i % 1000 == 0:
            print('processing %d/%d (%.2f%% done)' % (i, N, i * 100.0 / N))
    print('wrote ', params['output_dir'])


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--input_json', required=True)
    parser.add_argument('--output_dir', default='data')
    parser.add_argument('--images_root', default='')
    parser.add_argument('--att_size', default=14, type=int)
    parser.add_argument('--model', default='resnet101', type=str)
    parser.add_argument('--model_root', default='./data/imagenet_weights',
                        type=str)
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = parser.parse_args()
    params = vars(args)
    print('parsed input parameters:')
    print(json.dumps(params, indent=2))
    main(params)
