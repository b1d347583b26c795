"""Diversity metric suite over multi-sample predictions.

The port's copy of ``captioning_tpu/utils/eval_multi.py`` (the
reference's ``captioning/utils/eval_multi.py`` on the native scorers):
oracle best-of-n per metric (:71-119), Div-1/Div-2/gDiv-1 + mutual BLEU
(:121-175), self-CIDEr diversity (:177-215).  AllSPICE
(:36-69) requires the Java SPICE scene-graph pipeline and is gated: it
returns None when the coco-caption jar stack is absent (documented gap;
every other metric is native).
"""

from __future__ import annotations

import os

import numpy as np

from .cider_scorer import Bleu, Cider
from .coco_eval import evaluate_captions, ptb_tokenize
from .div_utils import compute_div_n, compute_global_div_n


def _caps_by_id(preds_n):
    caps = {}
    for d in preds_n:
        caps[d['image_id']] = caps.get(d['image_id'], []) + [d]
    return caps


def eval_allspice(dataset, preds_n, model_id, split):
    """Union-caption SPICE over the n samples per image (reference
    eval_multi.py:36-69 via COCOEvalCapSpice).

    Jar-gated: returns None cleanly when the SPICE jar is not discoverable.
    With a jar, each image's n captions are scored as one multi-sentence
    test input — the scene-graph parser unions tuples across sentences,
    which is exactly the AllSPICE semantics.
    """
    from .spice import find_spice_jar
    if not find_spice_jar():
        print('Warning: SPICE jar not available; AllSPICE skipped')
        return None
    from .eval_utils import getCOCO
    from .spice import SpiceScorer
    coco = getCOCO(dataset)
    valids = coco.valid_ids

    preds_filt_n = [p for p in preds_n if p['image_id'] in valids]
    print('using %d/%d predictions_n' % (len(preds_filt_n), len(preds_n)))
    caps_by_id = _caps_by_id(preds_filt_n)
    if not caps_by_id:
        return None
    ids = list(caps_by_id.keys())
    res = {i: [ptb_tokenize(d['caption']) for d in caps_by_id[i]]
           for i in ids}
    gts = {i: [ptb_tokenize(c) for c in coco.gts_for([i])[i]] for i in ids}

    sp_mean, sp_scores = SpiceScorer().compute_score(gts, res)
    out = {'AllSPICE': sp_mean}
    img_to_eval = {}
    for idx, i in enumerate(ids):
        img_to_eval[i] = {'image_id': i, 'SPICE': sp_scores[idx],
                          'caption': caps_by_id[i]}
    for k in sp_scores[0].keys():
        if k != 'All':
            vals = np.array([s[k]['f'] for s in sp_scores])
            finite = vals[vals == vals]  # NaN-filtered (empty when the
            # category never fired on this eval set)
            if finite.size:
                out['AllSPICE_' + k] = float(finite.mean())
            else:
                out['AllSPICE_' + k] = None
                out.setdefault('AllSPICE_skipped_categories', []).append(k)
    return {'overall': out, 'imgToEvalAllSPICE': img_to_eval}


def eval_oracle(dataset, preds_n, model_id, split):
    """Oracle / average best-of-n per metric (reference eval_multi.py:71-119)."""
    from .eval_utils import getCOCO
    coco = getCOCO(dataset)
    valids = coco.valid_ids

    caps_by_id = _caps_by_id([p for p in preds_n if p['image_id'] in valids])
    if not caps_by_id:
        return {'overall': {}, 'ImgToEval': {}}
    n_per = len(next(iter(caps_by_id.values())))

    for i in range(n_per):
        ids = list(caps_by_id.keys())
        res = {k: [caps_by_id[k][i]['caption']] for k in ids}
        gts = coco.gts_for(ids)
        _, img_to_eval = evaluate_captions(gts, res)
        for img_id in ids:
            caps_by_id[img_id][i]['scores'] = img_to_eval[img_id]

    out = {'overall': {}, 'ImgToEval': {}}
    for img_id in caps_by_id.keys():
        out['ImgToEval'][img_id] = {}
        metrics = [m for m in caps_by_id[img_id][0]['scores'].keys()
                   if m != 'image_id']
        for metric in metrics:
            vals = [c['scores'][metric] for c in caps_by_id[img_id]]
            out['ImgToEval'][img_id]['oracle_' + metric] = max(vals)
            out['ImgToEval'][img_id]['avg_' + metric] = sum(vals) / len(vals)
        out['ImgToEval'][img_id]['captions'] = caps_by_id[img_id]
    for metric in list(out['ImgToEval'].values())[0].keys():
        if metric == 'captions':
            continue
        tmp = np.array([v[metric] for v in out['ImgToEval'].values()])
        tmp = tmp[(tmp != -100) & (tmp == tmp)]
        # every image sentinel/NaN: report 0 with a skip count rather than
        # warning and propagating nan into the output json
        if tmp.size:
            out['overall'][metric] = tmp.mean()
        else:
            out['overall'][metric] = 0.0
            out['overall'].setdefault('skipped_metrics', []).append(metric)
    return out


def eval_div_stats(dataset, preds_n, model_id, split):
    """Div-1/Div-2/gDiv-1 + mutual BLEU (reference eval_multi.py:121-175)."""
    caps_by_id_raw = _caps_by_id(preds_n)
    n_per = len(next(iter(caps_by_id_raw.values())))

    caps_by_id = {k: [ptb_tokenize(d['caption']) for d in v]
                  for k, v in caps_by_id_raw.items()}

    div_1, _ = compute_div_n(caps_by_id, 1)
    div_2, _ = compute_div_n(caps_by_id, 2)
    globdiv_1, _ = compute_global_div_n(caps_by_id, 1)

    scorer = Bleu(4)
    all_scrs = []
    scrperimg = np.zeros((n_per, len(caps_by_id)))
    for i in range(n_per):
        temp_refs = {}
        cands = {}
        for k in caps_by_id:
            temp_refs[k] = caps_by_id[k][:i] + caps_by_id[k][i + 1:]
            cands[k] = [caps_by_id[k][i]]
        score, scores = scorer.compute_score(temp_refs, cands)
        all_scrs.append(score)
        scrperimg[i, :] = scores[1]
    all_scrs = np.array(all_scrs)

    out = {'overall': {'Div1': div_1, 'Div2': div_2, 'gDiv1': globdiv_1}}
    for k, score in zip(range(4), all_scrs.mean(axis=0).tolist()):
        out['overall']['mBLeu_%d' % (k + 1)] = score
    img_to_eval = {}
    for i, imgid in enumerate(caps_by_id.keys()):
        img_to_eval[imgid] = {'mBleu_2': scrperimg[:, i].mean(),
                              'individuals': caps_by_id_raw[imgid]}
    out['ImgToEval'] = img_to_eval
    return out


def eval_self_cider(dataset, preds_n, model_id, split):
    """Self-CIDEr diversity (reference eval_multi.py:177-215)."""
    from .eval_utils import getCOCO
    coco = getCOCO(dataset)
    valids = list(coco.valid_ids)

    # df over the eval set's reference captions
    scorer = Cider(df='corpus')
    gts = {i: [ptb_tokenize(c) for c in coco.gts_for([i])[i]] for i in valids}
    from .cider_scorer import precook
    crefs = [[precook(r) for r in gts[i]] for i in valids]
    scorer._compute_df_corpus(crefs)
    scorer.df_mode = 'cached'  # freeze the df for my_self_cider

    caps_by_id = _caps_by_id(preds_n)
    caps_by_id = {k: [ptb_tokenize(d['caption']) for d in v]
                  for k, v in caps_by_id.items()}
    img_ids = list(caps_by_id.keys())
    scores = scorer.my_self_cider([caps_by_id[i] for i in img_ids])

    def get_div(eigvals):
        eigvals = np.clip(eigvals, 0, None)
        return -np.log(np.sqrt(eigvals[-1]) /
                       (np.sqrt(eigvals).sum())) / np.log(len(eigvals))

    sc_scores = [get_div(np.linalg.eigvalsh(s / 10)) for s in scores]
    score = float(np.mean(np.array(sc_scores)))

    img_to_eval = {}
    for i, image_id in enumerate(img_ids):
        img_to_eval[image_id] = {'self_cider': sc_scores[i],
                                 'self_cider_mat': scores[i].tolist()}
    return {'overall': {'self_cider': score}, 'imgToEval': img_to_eval}
