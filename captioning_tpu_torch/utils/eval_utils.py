"""Validation / test evaluation loop (port of
``captioning_tpu/utils/eval_utils.py`` for one device).

``eval_split`` walks a split, takes the teacher-forced val loss where the
batch has labels, decodes (beam or greedy, entropy / perplexity sums
carried through the decode), truncates to ``num_images`` and runs
``language_eval`` over the port's copy of ``coco_eval``.  One
batch stays in flight: a batch's captions are post-processed after the
next batch's decode has been issued.  The mesh and multi-host branches of
the JAX loop, and the multi-sample ``eval_split_n``, are not ported.
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np
import torch

from ..modules import losses
from . import misc as utils
from .coco_eval import AnnotationDB, evaluate_captions

bad_endings = ['a', 'an', 'the', 'in', 'for', 'at', 'of', 'with', 'before',
               'after', 'on', 'upon', 'near', 'to', 'is', 'are', 'am', 'the']


def count_bad(sen):
    sen = sen.split(' ')
    return 1 if sen and sen[-1] in bad_endings else 0


def getCOCO(dataset) -> AnnotationDB:
    """Annotation file selection (reference eval_utils.py:39-44)."""
    if 'coco' in dataset:
        ann_file = 'coco-caption/annotations/captions_val2014.json'
        if not os.path.isfile(ann_file):
            ann_file = 'data/captions_val2014.json'
    elif 'flickr30k' in dataset or 'f30k' in dataset:
        ann_file = 'data/f30k_captions4eval.json'
    else:
        ann_file = dataset  # explicit path
    return AnnotationDB(ann_file)


def language_eval(dataset, preds, preds_n, eval_kwargs, split):
    """COCO metrics over the predictions (reference eval_utils.py:47-126)."""
    import json
    if preds_n:
        raise NotImplementedError('multi-sample (sample_n > 1) language '
                                  'eval is not ported yet; see ROADMAP.md')
    model_id = eval_kwargs.get('id', '')
    os.makedirs('eval_results', exist_ok=True)
    cache_path = os.path.join('eval_results/',
                              '.cache_' + model_id + '_' + split + '.json')
    coco = getCOCO(dataset)
    valids = coco.valid_ids
    preds_filt = [p for p in preds if p['image_id'] in valids]
    n = max(len(preds_filt), 1)
    mean_perplexity = sum(p['perplexity'] for p in preds_filt) / n
    mean_entropy = sum(p['entropy'] for p in preds_filt) / n
    print('using %d/%d predictions' % (len(preds_filt), len(preds)))
    with open(cache_path, 'w') as f:
        json.dump(preds_filt, f)

    ids = [p['image_id'] for p in preds_filt]
    res = {p['image_id']: [p['caption']] for p in preds_filt}
    overall, img_to_eval = evaluate_captions(coco.gts_for(ids), res)
    out = dict(overall)
    out['perplexity'] = mean_perplexity
    out['entropy'] = mean_entropy
    if img_to_eval and 'SPICE' in next(iter(img_to_eval.values())):
        for k in next(iter(img_to_eval.values()))['SPICE'].keys():
            if k != 'All':
                vals = np.array([v['SPICE'][k]['f']
                                 for v in img_to_eval.values()])
                finite = vals[vals == vals]
                out['SPICE_' + k] = (float(finite.mean()) if finite.size
                                     else None)
    for p in preds_filt:
        img_to_eval[p['image_id']]['caption'] = p['caption']
    out['bad_count_rate'] = (sum(count_bad(p['caption'])
                                 for p in preds_filt) / float(n))
    with open(os.path.join('eval_results/',
                           model_id + '_' + split + '.json'), 'w') as f:
        json.dump({'overall': out, 'imgToEval': img_to_eval}, f)
    return out


def _stats_from_sums(seq, stats, real_rows):
    """Per-caption entropy / perplexity from the decode's carried sums."""
    seq = seq.cpu().numpy()[:real_rows]
    denom = (seq > 0).sum(1) + 1
    entropy = stats['ent_sum'].cpu().numpy()[:real_rows] / denom
    perplexity = -stats['lp_sum'].cpu().numpy()[:real_rows] / denom
    return seq, entropy, perplexity


def eval_split(captioner, loader, eval_kwargs=None):
    """reference eval_utils.py:128-226 on ``captioner.device``.

    Returns (val_loss, predictions, lang_stats)."""
    eval_kwargs = eval_kwargs or {}
    verbose = eval_kwargs.get('verbose', True)
    verbose_loss = eval_kwargs.get('verbose_loss', 1)
    verbose_beam = eval_kwargs.get('verbose_beam', 0)
    num_images = eval_kwargs.get('num_images',
                                 eval_kwargs.get('val_images_use', -1))
    split = eval_kwargs.get('split', 'val')
    lang_eval = eval_kwargs.get('language_eval', 0)
    dataset = eval_kwargs.get('dataset', 'coco')
    if int(eval_kwargs.get('sample_n', 1) or 1) > 1:
        raise NotImplementedError('sample_n > 1 (eval_split_n) is not '
                                  'ported yet; see ROADMAP.md')
    os.environ['REMOVE_BAD_ENDINGS'] = str(
        eval_kwargs.get('remove_bad_endings', 0))
    if float(eval_kwargs.get('label_smoothing', 0) or 0) > 0 and verbose_loss:
        raise NotImplementedError('label-smoothed val loss is not ported '
                                  'yet; see ROADMAP.md')
    device = captioner.device

    loader.reset_iterator(split)
    vocab = loader.get_vocab()
    sample_opt = {k: eval_kwargs.get(k) for k in
                  ('sample_method', 'beam_size', 'temperature', 'group_size',
                   'diversity_lambda', 'decoding_constraint',
                   'block_trigrams', 'remove_bad_endings', 'suppress_UNK',
                   'length_penalty', 'max_length')
                  if eval_kwargs.get(k) is not None}
    sample_opt['sample_n'] = 1
    beam = (int(sample_opt.get('beam_size', 1) or 1) > 1 and
            sample_opt.get('sample_method', 'greedy') in ('greedy',
                                                          'beam_search'))
    rng = torch.Generator().manual_seed(int(eval_kwargs.get('seed', 0)))

    def dev(x, dtype=None):
        return None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dtype).to(device)

    n = 0
    loss = 0.0
    loss_sum = 0.0
    loss_evals = 1e-8
    predictions = []

    def _process(rec):
        """Post-process one issued batch, strictly in batch order."""
        nonlocal loss, loss_sum, loss_evals
        data = rec['data']
        if rec['loss_dev'] is not None:
            loss = float(rec['loss_dev'])
            loss_sum += loss
            loss_evals += 1
        seq, entropy, perplexity = _stats_from_sums(rec['seq'], rec['stats'],
                                                    len(data['infos']))
        if verbose_beam and rec['done'] is not None:
            beams = rec['done']['seq'].cpu().numpy()
            for i in range(beams.shape[0]):
                flat = beams[i].reshape(-1, beams.shape[-1])
                print('\n'.join(utils.decode_sequence(vocab, flat)))
                print('--' * 10)
        for k, sent in enumerate(utils.decode_sequence(vocab, seq)):
            entry = {'image_id': data['infos'][k]['id'], 'caption': sent,
                     'perplexity': float(perplexity[k]),
                     'entropy': float(entropy[k])}
            if eval_kwargs.get('dump_path', 0) == 1:
                entry['file_name'] = data['infos'][k]['file_path']
            predictions.append(entry)
            if eval_kwargs.get('dump_images', 0) == 1:
                # copy the source image for the vis/index.html viewer
                src = os.path.join(eval_kwargs.get('image_root', ''),
                                   data['infos'][k].get('file_path', ''))
                if os.path.isfile(src):
                    os.makedirs('vis/imgs', exist_ok=True)
                    dst = 'vis/imgs/img%d.jpg' % len(predictions)
                    print('cp "%s" %s' % (src, dst))
                    shutil.copyfile(src, dst)
            if verbose:
                print('image %s: %s' % (entry['image_id'], entry['caption']))
        for _ in range(rec['n'] - rec['ix1']):
            predictions.pop()
        if verbose:
            print('evaluating validation preformance... %d/%d (%f)'
                  % (rec['n'], rec['ix1'], loss))

    pending = None
    while True:
        data = loader.get_batch(split)
        n = n + len(data['infos'])
        fc = dev(data['fc_feats'], torch.float32)
        att = dev(data['att_feats'], torch.float32)
        am = dev(data['att_masks'], torch.float32)
        labels = dev(data.get('labels'), torch.long)
        masks = dev(data.get('masks'), torch.float32)

        loss_dev = None
        if labels is not None and verbose_loss:
            logprobs = captioner.forward_tf(fc, att, labels[..., :-1], am)
            loss_dev = losses.language_model_criterion(
                logprobs, labels[..., 1:], masks[..., 1:])

        rec = {'data': data, 'loss_dev': loss_dev, 'done': None}
        if beam:
            seq, stats, done = captioner.sample_beam(fc, att, am, rng,
                                                     sample_opt)
            rec.update(seq=seq, stats=stats, done=done)
        else:
            seq, stats = captioner.sample_stats(fc, att, am, rng, sample_opt)
            rec.update(seq=seq, stats=stats)

        ix1 = data['bounds']['it_max']
        if num_images != -1:
            ix1 = min(ix1, num_images)
        else:
            num_images = ix1
        rec['n'], rec['ix1'] = n, ix1
        if pending is not None:
            _process(pending)
        pending = rec
        if num_images >= 0 and n >= num_images:
            break
    if pending is not None:
        _process(pending)

    os.makedirs('eval_results', exist_ok=True)
    with open(os.path.join('eval_results/', '.saved_pred_'
                           + eval_kwargs.get('id', '') + '_' + split +
                           '.pkl'), 'wb') as f:
        pickle.dump((predictions, []), f)
    lang_stats = None
    if lang_eval == 1:
        lang_stats = language_eval(dataset, predictions, [], eval_kwargs,
                                   split)
    return loss_sum / loss_evals, predictions, lang_stats
