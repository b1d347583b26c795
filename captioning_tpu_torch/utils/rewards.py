"""SCST / structure-loss reward computation on the host.

The port's copy of ``captioning_tpu/utils/rewards.py`` (the reference's
``captioning/utils/rewards.py`` on the scorers of ``cider_scorer.py``).
Sequences are serialized as space-joined token-id strings terminated at
(and including) the first 0 (reference ``array_to_str``,
rewards.py:33-39), so the scorers need no detokenizer and the
prepro_ngrams ``-idxs`` doc-frequency cache applies directly.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .cider_scorer import Bleu, Cider, CiderD

CiderD_scorer = None
Cider_scorer = None
Bleu_scorer = None


def init_scorer(cached_tokens):
    global CiderD_scorer, Cider_scorer, Bleu_scorer
    CiderD_scorer = CiderD_scorer or CiderD(df=cached_tokens)
    Cider_scorer = Cider_scorer or Cider(df=cached_tokens)
    Bleu_scorer = Bleu_scorer or Bleu(4)


def array_to_str(arr):
    out = ''
    for i in range(len(arr)):
        out += str(int(arr[i])) + ' '
        if arr[i] == 0:
            break
    return out.strip()


def get_self_critical_reward(greedy_res, data_gts, gen_result, opt):
    """reward = sample score - per-image greedy baseline, tiled over time
    (reference rewards.py:41-81)."""
    batch_size = len(data_gts)
    gen_result = np.asarray(gen_result)
    greedy_res = np.asarray(greedy_res)
    gen_result_size = gen_result.shape[0]
    seq_per_img = gen_result_size // batch_size
    assert greedy_res.shape[0] == batch_size

    res = OrderedDict()
    for i in range(gen_result_size):
        res[i] = [array_to_str(gen_result[i])]
    for i in range(batch_size):
        res[gen_result_size + i] = [array_to_str(greedy_res[i])]

    gts = OrderedDict()
    for i in range(len(data_gts)):
        gts[i] = [array_to_str(data_gts[i][j]) for j in range(len(data_gts[i]))]

    res_ = [{'image_id': i, 'caption': res[i]} for i in range(len(res))]
    res__ = {i: res[i] for i in range(len(res_))}
    gts_ = {i: gts[i // seq_per_img] for i in range(gen_result_size)}
    gts_.update({i + gen_result_size: gts[i] for i in range(batch_size)})
    if opt.cider_reward_weight > 0:
        _, cider_scores = CiderD_scorer.compute_score(gts_, res_)
    else:
        cider_scores = 0
    if opt.bleu_reward_weight > 0:
        _, bleu_scores = Bleu_scorer.compute_score(gts_, res__)
        bleu_scores = np.array(bleu_scores[3])
    else:
        bleu_scores = 0
    scores = (opt.cider_reward_weight * cider_scores +
              opt.bleu_reward_weight * bleu_scores)

    scores = scores[:gen_result_size].reshape(batch_size, seq_per_img) - \
        scores[-batch_size:][:, np.newaxis]
    scores = scores.reshape(gen_result_size)
    rewards = np.repeat(scores[:, np.newaxis], gen_result.shape[1], 1)
    return rewards.astype(np.float32)


def get_scores(data_gts, gen_result, opt):
    """Per-sequence scores for structure losses (reference rewards.py:83-114)."""
    gen_result = np.asarray(gen_result)
    batch_size = gen_result.shape[0]
    seq_per_img = batch_size // len(data_gts)

    res = OrderedDict()
    for i in range(batch_size):
        res[i] = [array_to_str(gen_result[i])]

    gts = OrderedDict()
    for i in range(len(data_gts)):
        gts[i] = [array_to_str(data_gts[i][j]) for j in range(len(data_gts[i]))]

    res_ = [{'image_id': i, 'caption': res[i]} for i in range(batch_size)]
    res__ = {i: res[i] for i in range(batch_size)}
    gts = {i: gts[i // seq_per_img] for i in range(batch_size)}
    if opt.cider_reward_weight > 0:
        _, cider_scores = CiderD_scorer.compute_score(gts, res_)
    else:
        cider_scores = 0
    if opt.bleu_reward_weight > 0:
        _, bleu_scores = Bleu_scorer.compute_score(gts, res__)
        bleu_scores = np.array(bleu_scores[3])
    else:
        bleu_scores = 0
    scores = (opt.cider_reward_weight * cider_scores +
              opt.bleu_reward_weight * bleu_scores)
    return np.asarray(scores, np.float32)


def get_self_cider_scores(data_gts, gen_result, opt):
    """Diversity reward via eigvals of the self-CIDEr gram matrix
    (reference rewards.py:116-135)."""
    gen_result = np.asarray(gen_result)
    batch_size = gen_result.shape[0]
    seq_per_img = batch_size // len(data_gts)

    res = [array_to_str(gen_result[i]) for i in range(batch_size)]

    scores = []
    for i in range(len(data_gts)):
        tmp = Cider_scorer.my_self_cider(
            [res[i * seq_per_img:(i + 1) * seq_per_img]])

        def get_div(eigvals):
            eigvals = np.clip(eigvals, 0, None)
            return -np.log(np.sqrt(eigvals[-1]) /
                           (np.sqrt(eigvals).sum())) / np.log(len(eigvals))
        scores.append(get_div(np.linalg.eigvalsh(tmp[0] / 10)))
    return np.array(scores, np.float32)
