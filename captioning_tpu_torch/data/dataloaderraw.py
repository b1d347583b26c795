"""Eval on a folder of raw images: the ResNet runs on the fly.

Port of ``captioning_tpu/data/dataloaderraw.py``: lists the images of a
folder (or of a ``coco_json`` file list) and gives each batch the 2048-wide
fc and 14 x 14 x 2048 att features of ``models/resnet.py``, computed on
the loader's ``device`` (cuda unless asked otherwise).  Needs a
torchvision-format checkpoint at ``<model_root>/<cnn_model>.pth``
(default ``./data/imagenet_weights``); nothing is downloaded.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..models.resnet import load_resnet, resnet_features


def _load_image(path):
    from PIL import Image
    img = Image.open(path).convert('RGB')
    return np.asarray(img).astype('float32') / 255.0


class DataLoaderRaw:
    def __init__(self, opt):
        self.opt = opt
        self.coco_json = opt.get('coco_json', '')
        self.folder_path = opt.get('folder_path', '')
        self.batch_size = opt.get('batch_size', 1)
        self.seq_per_img = 1
        cnn_model = opt.get('cnn_model', 'resnet101')
        model_root = opt.get('model_root', './data/imagenet_weights')

        weights = os.path.join(model_root, cnn_model + '.pth')
        if not os.path.isfile(weights):
            raise FileNotFoundError(
                'DataLoaderRaw needs %s (torchvision %s checkpoint); '
                'place it there manually in zero-egress environments.'
                % (weights, cnn_model))
        self.resnet = load_resnet(weights, cnn_model,
                                  opt.get('device', 'cuda'))

        # load the json containing the filenames, or scan the folder
        self.files = []
        self.ids = []
        if len(self.coco_json) > 0:
            print('reading from ' + self.coco_json)
            with open(self.coco_json) as f:
                anns = json.load(f)
            self.files = [os.path.join(self.folder_path, ann['file_name'])
                          for ann in anns['images']]
            self.ids = [ann['id'] for ann in anns['images']]
        else:
            print('listing all images in directory ' + self.folder_path)
            exts = {'.jpg', '.jpeg', '.png', '.ppm', '.JPG', '.JPEG',
                    '.PNG', '.PPM'}
            n = 1
            for root, dirs, files in os.walk(self.folder_path, topdown=False):
                for file in files:
                    # joined to the folder, not to ``root``, as the
                    # reference does: a subfolder's file is listed under
                    # the top folder's path
                    fullpath = os.path.join(self.folder_path, file)
                    if os.path.splitext(fullpath)[1] in exts:
                        self.files.append(fullpath)
                        self.ids.append(str(n))
                        n += 1

        self.N = len(self.files)
        print('DataLoaderRaw found ', self.N, ' images')
        self.iterator = 0
        self.dataset = self  # mirrors the reference's aliasing
        self.ix_to_word = None

    def get_batch(self, split, batch_size=None):
        batch_size = batch_size or self.batch_size
        fc_batch = np.zeros((batch_size, 2048), dtype='float32')
        att_batch = np.zeros((batch_size, 14 * 14, 2048), dtype='float32')
        max_index = self.N
        wrapped = False
        infos = []

        for i in range(batch_size):
            ri = self.iterator
            ri_next = ri + 1
            if ri_next >= max_index:
                ri_next = 0
                wrapped = True
            self.iterator = ri_next

            img = _load_image(self.files[ri])
            fc, att = resnet_features(self.resnet, img)
            fc_batch[i] = fc.cpu().numpy()
            att_batch[i] = att.cpu().numpy().reshape(-1, 2048)
            infos.append({'id': self.ids[ri], 'file_path': self.files[ri]})

        data = {}
        data['fc_feats'] = fc_batch
        data['att_feats'] = att_batch
        data['att_masks'] = np.ones(att_batch.shape[:2], dtype='float32')
        data['labels'] = None
        data['masks'] = None
        data['gts'] = [[] for _ in range(batch_size)]
        data['bounds'] = {'it_pos_now': self.iterator, 'it_max': self.N,
                          'wrapped': wrapped}
        data['infos'] = infos
        return data

    def reset_iterator(self, split):
        self.iterator = 0

    def get_vocab_size(self):
        return len(self.ix_to_word)

    def get_vocab(self):
        return self.ix_to_word

    @property
    def vocab_size(self):
        return self.get_vocab_size()

    @property
    def seq_length(self):
        return 1
