"""Validation / test evaluation loop (port of
``captioning_tpu/utils/eval_utils.py`` for one device).

``eval_split`` walks a split, takes the teacher-forced val loss where the
batch has labels, decodes (beam or the sample family with the entropy /
perplexity sums carried through the decode; diverse groups and other
methods through the per-step tables), truncates to ``num_images`` and runs
``language_eval`` over the port's copy of ``coco_eval``; ``eval_split_n``
adds ``sample_n`` captions an image, which ``language_eval`` scores with
the diversity suite of ``eval_multi``.  One batch stays in flight: a
batch's captions are post-processed after the next batch's decode has been
issued.  Under a data axis of several ranks (``parallel.mesh``) the eval
is cooperative, as the JAX loop's multi-host branch: every rank walks the
same loader state and decodes its slice of each global batch, and every
rank ends with the same merged predictions, val loss and metrics.  Under
a model axis the images split over the data axis alone: the ranks of a
model group decode the same rows in lockstep (the vocab's shards merged
across them), and model rank 0 alone contributes them to the merge.
"""

from __future__ import annotations

import functools
import os
import pickle
import shutil

import numpy as np
import torch

from ..modules import losses
from ..parallel import mesh
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
    """COCO metrics over the predictions (reference eval_utils.py:47-126);
    with ``preds_n`` (the multi-sample predictions of ``eval_split_n``) the
    novelty and vocabulary of the samples and the diversity suite of
    ``eval_multi`` too."""
    import json
    model_id = eval_kwargs.get('id', '')
    eval_oracle = eval_kwargs.get('eval_oracle', 0)
    out = {}
    if len(preds_n) > 0:
        if 'coco' in dataset:
            dataset_file = 'data/dataset_coco.json'
        elif 'flickr30k' in dataset or 'f30k' in dataset:
            dataset_file = 'data/dataset_flickr30k.json'
        else:
            dataset_file = None
        if dataset_file and os.path.isfile(dataset_file):
            with open(dataset_file) as f:
                images = json.load(f)['images']
            training_sentences = set(
                ' '.join(s['tokens']) for img in images
                if img.get('split') not in ['val', 'test']
                for s in img['sentences'])
            generated_sentences = set(p['caption'] for p in preds_n)
            novels = generated_sentences - training_sentences
            out['novel_sentences'] = float(len(novels)) / len(preds_n)
            words = []
            for sent in generated_sentences:
                words += sent.split()
            out['vocab_size'] = len(set(words))

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
    out.update(overall)
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

    if len(preds_n) > 0:
        from . import eval_multi
        cache_path_n = os.path.join(
            'eval_results/', '.cache_' + model_id + '_' + split + '_n.json')
        allspice = eval_multi.eval_allspice(dataset, preds_n, model_id, split)
        if allspice:
            out.update(allspice['overall'])
        div_stats = eval_multi.eval_div_stats(dataset, preds_n, model_id,
                                              split)
        out.update(div_stats['overall'])
        oracle = None
        if eval_oracle:
            oracle = eval_multi.eval_oracle(dataset, preds_n, model_id, split)
            out.update(oracle['overall'])
        self_cider = eval_multi.eval_self_cider(dataset, preds_n, model_id,
                                                split)
        out.update(self_cider['overall'])
        with open(cache_path_n, 'w') as f:
            json.dump({'allspice': allspice, 'div_stats': div_stats,
                       'oracle': oracle, 'self_cider': self_cider}, f)

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


def _sample_family(method: str) -> bool:
    """The methods the carried-stats route serves (the JAX
    ``Captioner._dynamic_sample_params`` family)."""
    return method in ('greedy', 'gumbel', 'sample') or method.startswith(
        'top')


def decode_entry(captioner, kind: str, opt):
    """The entry that decodes ``kind`` ('beam' or 'stats') with ``opt``:
    the graph decode (``sample_beam_graphed`` / ``sample_stats_graphed``,
    as the JAX ``eval_split`` calls the ``_jit`` ones) where its route
    takes the options, else the eager ``sample_beam`` / ``sample_stats``."""
    eager = {'beam': 'sample_beam', 'stats': 'sample_stats'}[kind]
    if captioner.graph_route(kind, opt):
        return getattr(captioner, eager)
    return getattr(captioner, eager + '_graphed')


def eval_split(captioner, loader, eval_kwargs=None):
    """reference eval_utils.py:128-226 on ``captioner.device``.

    Decodes by beam (the carried sums), the sample family at one group (the
    carried sums, the exact early exit) or else the per-step tables (the
    'slow' route: diverse groups, whose group 0 is reported, and any other
    method); with ``sample_n > 1`` each batch also goes through
    ``eval_split_n``.  Sampling draws from one generator on the device,
    seeded from ``seed`` (plus the data index under a data axis).

    Cooperative under a data axis (data > 1): each global batch is padded
    to a multiple of the data axis (pad rows repeat row 0 with zero masks, as
    the JAX ``_globalize_batch``), each rank decodes its
    ``local_batch_slice`` and keeps its real rows, the val loss divides the
    summed numerators by the summed mask, ``gather_predictions`` merges the
    ranks' captions in rank order, and rank 0's ``language_eval`` of the
    merged list reaches every rank.  Returns (val_loss, predictions,
    lang_stats)."""
    eval_kwargs = eval_kwargs or {}
    verbose = eval_kwargs.get('verbose', True)
    verbose_loss = eval_kwargs.get('verbose_loss', 1)
    verbose_beam = eval_kwargs.get('verbose_beam', 0)
    num_images = eval_kwargs.get('num_images',
                                 eval_kwargs.get('val_images_use', -1))
    split = eval_kwargs.get('split', 'val')
    lang_eval = eval_kwargs.get('language_eval', 0)
    dataset = eval_kwargs.get('dataset', 'coco')
    sample_n = eval_kwargs.get('sample_n', 1)
    os.environ['REMOVE_BAD_ENDINGS'] = str(
        eval_kwargs.get('remove_bad_endings', 0))
    label_smoothing = float(eval_kwargs.get('label_smoothing', 0) or 0)
    device = captioner.device
    grid = mesh.current()
    world, main = grid.world, mesh.is_main_process()
    # the images split over the data axis; a model group's ranks decode
    # the same rows, and its model rank 0 alone contributes them
    global_denom = (functools.partial(mesh.all_reduce_sum,
                                      group=grid.data_group)
                    if grid.data > 1 else None)
    mine = grid.model_index == 0
    if world > 1 and main:
        print('eval_split: cooperative decode over %d ranks' % world)

    loader.reset_iterator(split)
    vocab = loader.get_vocab()
    sample_opt = {k: eval_kwargs.get(k) for k in
                  ('sample_method', 'beam_size', 'temperature', 'group_size',
                   'diversity_lambda', 'decoding_constraint',
                   'block_trigrams', 'remove_bad_endings', 'suppress_UNK',
                   'length_penalty', 'max_length')
                  if eval_kwargs.get(k) is not None}
    sample_opt['sample_n'] = 1
    method = sample_opt.get('sample_method', 'greedy')
    group_size = int(sample_opt.get('group_size', 1) or 1)
    beam = (int(sample_opt.get('beam_size', 1) or 1) > 1 and
            method in ('greedy', 'beam_search'))
    stats_route = not beam and group_size == 1 and _sample_family(method)
    sample_beam = decode_entry(captioner, 'beam', sample_opt)
    sample_stats = decode_entry(captioner, 'stats', sample_opt)
    rng = torch.Generator(device).manual_seed(
        int(eval_kwargs.get('seed', 0)) + grid.data_index)

    def dev(x, dtype=None):
        return None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dtype).to(device)

    n = 0
    loss = 0.0
    loss_sum = 0.0
    loss_evals = 1e-8
    predictions = []
    n_predictions = []

    def _process(rec):
        """Post-process one issued batch, strictly in batch order."""
        nonlocal loss, loss_sum, loss_evals
        data, rows = rec['data'], rec['rows']
        real_rows = len(rows)
        if rec['loss_dev'] is not None:
            loss = float(rec['loss_dev'])
            loss_sum += loss
            loss_evals += 1
        if rec['kind'] != 'slow':
            seq, entropy, perplexity = _stats_from_sums(
                rec['seq'], rec['stats'], real_rows)
        else:
            seq = rec['seq'].cpu().numpy()[:real_rows * group_size]
            lp = rec['lp'].cpu().numpy()[:real_rows * group_size]
            if group_size > 1:
                # diverse sampling folds groups into rows [B*G, L]; the
                # split loop reports one caption per image: group 0 (use
                # eval_split_n / dgreedy for all groups)
                seq = seq.reshape(-1, group_size, seq.shape[-1])[:, 0]
                lp = lp.reshape((-1, group_size) + lp.shape[1:])[:, 0]
            denom = (seq > 0).sum(1) + 1
            if lp.ndim == 3:
                entropy = -(np.exp(lp) * lp).sum(-1).sum(1) / denom
                perplexity = -np.take_along_axis(
                    lp, seq[..., None], axis=2)[..., 0].sum(1) / denom
            else:
                # diverse sampling returns only the sampled logprob per step
                # [N, L]: perplexity from them (a step counts while no
                # earlier token ended the row), entropy unavailable
                keep = np.concatenate(
                    [np.ones((seq.shape[0], 1), bool),
                     np.cumprod(seq[:, :-1] > 0, axis=1).astype(bool)],
                    axis=1)
                entropy = np.zeros(lp.shape[0], lp.dtype)
                perplexity = -np.where(keep, lp, 0.0).sum(1) / denom
        if verbose_beam and rec['done'] is not None:
            # every finished beam of each image
            beams = rec['done']['seq'].cpu().numpy()[:real_rows]
            for i in range(beams.shape[0]):
                flat = beams[i].reshape(-1, beams.shape[-1])
                print('\n'.join(utils.decode_sequence(vocab, flat)))
                print('--' * 10)
        entries = []
        for k, sent in enumerate(utils.decode_sequence(vocab, seq)):
            info = data['infos'][rows[k]]
            entry = {'image_id': info['id'], 'caption': sent,
                     'perplexity': float(perplexity[k]),
                     'entropy': float(entropy[k])}
            if eval_kwargs.get('dump_path', 0) == 1:
                entry['file_name'] = info['file_path']
            entries.append(entry)
        # the ranks' rows in rank order: the global batch's real rows
        for k, entry in enumerate(mesh.gather_predictions(
                entries if mine else [])):
            predictions.append(entry)
            if eval_kwargs.get('dump_images', 0) == 1 and main:
                # copy the source image for the vis/index.html viewer
                src = os.path.join(eval_kwargs.get('image_root', ''),
                                   data['infos'][k].get('file_path', ''))
                if os.path.isfile(src):
                    os.makedirs('vis/imgs', exist_ok=True)
                    dst = 'vis/imgs/img%d.jpg' % len(predictions)
                    print('cp "%s" %s' % (src, dst))
                    shutil.copyfile(src, dst)
            if verbose and main:
                print('image %s: %s' % (entry['image_id'], entry['caption']))
        if sample_n > 1:
            entries = []
            eval_split_n(captioner, entries, rec['inputs'] + [
                dict(data, infos=[data['infos'][i] for i in rows])],
                vocab, rng, eval_kwargs)
            n_predictions.extend(mesh.gather_predictions(
                entries if mine else []))
        for _ in range(rec['n'] - rec['ix1']):
            predictions.pop()
        if verbose and main:
            print('evaluating validation preformance... %d/%d (%f)'
                  % (rec['n'], rec['ix1'], loss))

    pending = None
    while True:
        data = loader.get_batch(split)
        n = n + len(data['infos'])
        arrays = {k: data.get(k) for k in _BATCH_KEYS}
        rows = range(len(data['infos']))     # the global rows decoded here
        if grid.data > 1:
            arrays, rows = local_rows(arrays, len(data['infos']))
        fc = dev(arrays['fc_feats'], torch.float32)
        att = dev(arrays['att_feats'], torch.float32)
        am = dev(arrays['att_masks'], torch.float32)
        labels = dev(arrays['labels'], torch.long)
        masks = dev(arrays['masks'], torch.float32)

        loss_dev = None
        if labels is not None and verbose_loss:
            logprobs = captioner.forward_tf(fc, att, labels[..., :-1], am)
            if label_smoothing > 0:
                loss_dev = losses.label_smoothing_criterion(
                    logprobs, labels[..., 1:], masks[..., 1:],
                    label_smoothing, denom=global_denom)
            else:
                loss_dev = losses.language_model_criterion(
                    logprobs, labels[..., 1:], masks[..., 1:],
                    denom=global_denom)
            # the data ranks' shares sum to the global batch's loss
            loss_dev = mesh.all_reduce_sum(loss_dev, grid.data_group)

        rec = {'data': data, 'rows': rows, 'loss_dev': loss_dev,
               'done': None, 'inputs': [fc, att, am]}
        if beam:
            seq, stats, done = sample_beam(fc, att, am, rng, sample_opt)
            rec.update(kind='beam', seq=seq, stats=stats, done=done)
        elif stats_route:
            seq, stats = sample_stats(fc, att, am, rng, sample_opt)
            rec.update(kind='stats', seq=seq, stats=stats)
        else:
            seq, lp = captioner.sample(fc, att, am, rng, sample_opt)
            rec.update(kind='slow', seq=seq, lp=lp)

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

    if len(n_predictions) > 0 and 'perplexity' in n_predictions[0]:
        n_predictions = sorted(n_predictions, key=lambda x: x['perplexity'])
    lang_stats = None
    if main:
        os.makedirs('eval_results', exist_ok=True)
        with open(os.path.join('eval_results/', '.saved_pred_'
                               + eval_kwargs.get('id', '') + '_' + split +
                               '.pkl'), 'wb') as f:
            pickle.dump((predictions, n_predictions), f)
        if lang_eval == 1:
            lang_stats = language_eval(dataset, predictions, n_predictions,
                                       eval_kwargs, split)
    lang_stats = mesh.broadcast_object(lang_stats)
    return loss_sum / loss_evals, predictions, lang_stats


_BATCH_KEYS = ('fc_feats', 'att_feats', 'att_masks', 'labels', 'masks')


def local_rows(arrays, real: int):
    """This rank's part of a global batch (numpy arrays by ``_BATCH_KEYS``;
    None stays None) and the global rows it holds that are real: the batch
    padded to a multiple of the world (pad rows repeat row 0, their masks
    zero), then ``local_batch_slice`` of it."""
    pad = (-real) % mesh.current().data
    sl = mesh.local_batch_slice(real + pad)
    out = {}
    for key, x in arrays.items():
        if x is not None and pad:
            x = np.asarray(x)
            rep = np.zeros_like(x[:1]) if key == 'masks' else x[:1]
            x = np.concatenate([x] + [rep] * pad, axis=0)
        out[key] = None if x is None else np.asarray(x)[sl]
    return out, range(sl.start, min(sl.stop, real))


def eval_split_n(captioner, n_predictions, input_data, vocab, rng,
                 eval_kwargs=None):
    """Multi-sample eval (reference eval_utils.py:230-281): ``sample_n``
    captions an image by ``sample_n_method``, appended to
    ``n_predictions``: 'bs' (the beams of one beam search of width
    sample_n), 'sample' / 'gumbel' / 'top<k>' / 'top<p>' (sample_n draws,
    with their perplexity), 'dbs' (the best beam of each of sample_n
    diverse groups of ``beam_size`` beams) or 'd<method>' (diverse sampling
    by <method> in sample_n groups).  ``rng`` draws the samples; the
    decoding options of ``eval_kwargs`` (the constraints, temperature,
    length penalty) apply.  ``diversity_lambda`` does not: the diverse
    methods decode at the engine's default, as the JAX package's
    ``eval_split_n`` does (the reference passes it through)."""
    eval_kwargs = eval_kwargs or {}
    verbose = eval_kwargs.get('verbose', True)
    beam_size = eval_kwargs.get('beam_size', 1)
    sample_n = eval_kwargs.get('sample_n', 1)
    sample_n_method = eval_kwargs.get('sample_n_method', 'sample')
    fc, att, am, data = input_data
    B = len(data['infos'])
    base = {k: eval_kwargs.get(k) for k in
            ('temperature', 'decoding_constraint', 'block_trigrams',
             'remove_bad_endings', 'suppress_UNK', 'length_penalty')
            if eval_kwargs.get(k) is not None}

    def add(sents, per_image, extra=None):
        for k, sent in enumerate(sents):
            entry = {'image_id': data['infos'][k // per_image]['id'],
                     'caption': sent}
            if extra is not None:
                entry['perplexity'] = float(extra[k])
            n_predictions.append(entry)

    if sample_n_method == 'bs':
        opt = dict(base, sample_n=sample_n, beam_size=sample_n, group_size=1)
        _, _, done = decode_entry(captioner, 'beam', opt)(fc, att, am, rng,
                                                          opt)
        seqs = done['seq'][:, 0].cpu().numpy()[:B]          # [B, bdash, L]
        add(utils.decode_sequence(vocab, seqs[:, :sample_n].reshape(
            -1, seqs.shape[-1])), sample_n)
    elif _sample_family(sample_n_method):
        opt = dict(base, sample_n=sample_n, sample_method=sample_n_method,
                   beam_size=1, group_size=1)
        seq, lp = captioner.sample(fc, att, am, rng, opt)
        seq = seq.cpu().numpy()[:B * sample_n]
        lp = lp.cpu().numpy()[:B * sample_n]
        perplexity = -np.take_along_axis(
            lp, seq[..., None], axis=2)[..., 0].sum(1) / (
                (seq > 0).sum(1) + 1)
        add(utils.decode_sequence(vocab, seq), sample_n, perplexity)
    elif sample_n_method == 'dbs':
        opt = dict(base, beam_size=beam_size * sample_n,
                   group_size=sample_n)
        _, _, done = decode_entry(captioner, 'beam', opt)(fc, att, am, rng,
                                                          opt)
        seqs = done['seq'][:, :, 0].cpu().numpy()[:B]  # best of each group
        add(utils.decode_sequence(vocab, seqs.reshape(-1, seqs.shape[-1])),
            sample_n)
    else:
        opt = dict(base, sample_method=sample_n_method[1:],
                   group_size=sample_n, beam_size=1)
        seq, _ = captioner.sample(fc, att, am, rng, opt)
        add(utils.decode_sequence(vocab, seq.cpu().numpy()[:B * sample_n]),
            sample_n)
    if verbose:
        for entry in sorted(n_predictions[-B * sample_n:],
                            key=lambda x: str(x['image_id'])):
            print('image %s: %s' % (entry['image_id'], entry['caption']))
