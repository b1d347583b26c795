"""Self-contained COCO caption evaluation (no Java, no submodules).

Replaces the reference's coco-caption submodule stack
(``captioning/utils/eval_utils.py:20-24``: pycocotools COCO
+ COCOEvalCap with PTBTokenizer(Java), BLEU, METEOR(Java), ROUGE-L, CIDEr,
SPICE(Java)).  Native reimplementations:

* PTB tokenizer: native port of Stanford PTBTokenizer semantics
  (contraction splitting, hyphenated words whole, abbreviation periods)
  + the coco-caption punctuation filter — see ptb_tokenizer.py.
* BLEU-1..4: coco-caption BleuScorer semantics ('closest' length BP).
* ROUGE-L: beta=1.2 LCS F-measure, max over refs.
* CIDEr: corpus-df tf-idf, as in the cider submodule.
* METEOR: when the Java METEOR 1.5 jar is discoverable it is invoked via
  subprocess and reported under the standard ``METEOR`` key; otherwise a
  native exact+stem alignment approximation is reported as
  ``METEOR_approx`` (never ``METEOR`` — the keys must not silently
  disagree with reference-published numbers).
* SPICE needs a Java scene-graph parser; it is gated: when the
  coco-caption jar stack is discoverable it runs via subprocess
  (``spice.py``) including the per-category breakdown, otherwise SPICE
  keys are omitted.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

from .cider_scorer import Bleu, Cider

# Native PTB tokenization matching the Java PTBTokenizer + coco-caption
# punctuation filter (see ptb_tokenizer.py for the fidelity contract)
from .ptb_tokenizer import ptb_tokenize  # noqa: F401  (re-exported API)


def tokenize_dict(d: Dict[int, List[str]]) -> Dict[int, List[str]]:
    return {k: [ptb_tokenize(c) for c in v] for k, v in d.items()}


def rouge_l(hyp: str, refs: List[str], beta: float = 1.2) -> float:
    """coco-caption Rouge: max LCS F-measure over refs."""
    def lcs(a, b):
        m, n = len(a), len(b)
        dp = np.zeros((m + 1, n + 1), dtype=np.int32)
        for i in range(m):
            for j in range(n):
                dp[i + 1, j + 1] = dp[i, j] + 1 if a[i] == b[j] else \
                    max(dp[i, j + 1], dp[i + 1, j])
        return int(dp[m, n])

    h = hyp.split()
    prec, rec = [], []
    for ref in refs:
        r = ref.split()
        l = lcs(h, r)
        prec.append(l / max(len(h), 1))
        rec.append(l / max(len(r), 1))
    p, r = max(prec), max(rec)
    if p != 0 and r != 0:
        return ((1 + beta ** 2) * p * r) / (r + beta ** 2 * p)
    return 0.0


def meteor_like(hyp: str, refs: List[str]) -> float:
    """Native METEOR approximation — NOT METEOR. Exact + Porter-stem
    greedy first-fit alignment stages reusing METEOR 1.5's en constants
    (alpha=0.85, beta=0.2, gamma=0.6, stem weight 0.6), but with no
    synonym/paraphrase tables and a first-fit chunk count rather than the
    jar's beam alignment minimizing chunks — scores are close but not
    comparable to published METEOR numbers.  Reported as
    ``METEOR_approx``, never ``METEOR``."""
    from .stemmer import porter_stem
    alpha, beta, gamma, w_stem = 0.85, 0.2, 0.6, 0.6
    h = hyp.split()
    h_stem = [porter_stem(w) for w in h]
    best = 0.0
    for ref in refs:
        r = ref.split()
        r_stem = [porter_stem(w) for w in r]
        # two-stage greedy alignment: all exact matches first, then stem
        # matches over the leftovers (METEOR applies matchers by priority)
        used_h = [False] * len(h)
        used_r = [False] * len(r)
        matches = []  # (h_pos, r_pos, weight)
        for i, w in enumerate(h):
            for j, rw in enumerate(r):
                if not used_r[j] and w == rw:
                    used_h[i] = used_r[j] = True
                    matches.append((i, j, 1.0))
                    break
        for i, ws in enumerate(h_stem):
            if used_h[i]:
                continue
            for j, rs in enumerate(r_stem):
                if not used_r[j] and ws == rs:
                    used_h[i] = used_r[j] = True
                    matches.append((i, j, w_stem))
                    break
        m = len(matches)
        if m == 0:
            continue
        mw = sum(w for _, _, w in matches)
        p = mw / max(len(h), 1)
        q = mw / max(len(r), 1)
        f_mean = p * q / (alpha * p + (1 - alpha) * q)
        # chunks: contiguous runs in both h and r over the aligned pairs
        matches.sort()
        chunks = 1
        for (i1, j1, _), (i2, j2, _) in zip(matches, matches[1:]):
            if not (i2 == i1 + 1 and j2 == j1 + 1):
                chunks += 1
        frag = chunks / m
        score = f_mean * (1 - gamma * (frag ** beta))
        best = max(best, score)
    return best


class COCOResult(dict):
    pass


def evaluate_captions(gts: Dict[int, List[str]], res: Dict[int, List[str]],
                      tokenize: bool = True):
    """COCOEvalCap equivalent: returns (overall dict, imgToEval dict)."""
    if tokenize:
        gts = tokenize_dict(gts)
        res = tokenize_dict(res)
    ids = list(res.keys())

    overall = {}
    img_to_eval = {i: {'image_id': i} for i in ids}

    # BLEU
    bleu = Bleu(4)
    corpus, per_n = bleu.compute_score(gts, res)
    for n in range(4):
        overall['Bleu_%d' % (n + 1)] = corpus[n]
        for idx, i in enumerate(ids):
            img_to_eval[i]['Bleu_%d' % (n + 1)] = per_n[n][idx]

    # ROUGE_L
    rl = [rouge_l(res[i][0], gts[i]) for i in ids]
    overall['ROUGE_L'] = float(np.mean(rl))
    for idx, i in enumerate(ids):
        img_to_eval[i]['ROUGE_L'] = rl[idx]

    # METEOR: real jar when discoverable, else the honest approximation key
    from .meteor import find_meteor_jar
    if find_meteor_jar():
        from .meteor import MeteorScorer
        scorer = MeteorScorer()
        try:
            m_mean, m_scores = scorer.compute_score(gts, res)
        finally:
            scorer.close()
        overall['METEOR'] = m_mean
        for idx, i in enumerate(ids):
            img_to_eval[i]['METEOR'] = m_scores[idx]
    else:
        mt = [meteor_like(res[i][0], gts[i]) for i in ids]
        overall['METEOR_approx'] = float(np.mean(mt))
        for idx, i in enumerate(ids):
            img_to_eval[i]['METEOR_approx'] = mt[idx]

    # CIDEr (corpus df)
    cider = Cider(df='corpus')
    res_list = [{'image_id': i, 'caption': res[i]} for i in ids]
    c_mean, c_scores = cider.compute_score(gts, res_list)
    overall['CIDEr'] = c_mean
    for idx, i in enumerate(ids):
        img_to_eval[i]['CIDEr'] = float(c_scores[idx])

    # SPICE: jar-gated (reference eval_utils.py:96-99 reads per-category
    # {'f': ...} dicts out of imgToEval — same shape here)
    from .spice import find_spice_jar
    if find_spice_jar():
        from .spice import SpiceScorer
        sp_mean, sp_scores = SpiceScorer().compute_score(gts, res)
        overall['SPICE'] = sp_mean
        for idx, i in enumerate(ids):
            img_to_eval[i]['SPICE'] = sp_scores[idx]

    return overall, img_to_eval


class AnnotationDB:
    """Minimal stand-in for pycocotools.coco.COCO over a captions json."""

    def __init__(self, ann_file: str):
        data = json.load(open(ann_file))
        self.img_to_anns = defaultdict(list)
        for ann in data['annotations']:
            self.img_to_anns[ann['image_id']].append(ann['caption'])
        self.valid_ids = set(self.img_to_anns.keys())

    def get_img_ids(self):
        return list(self.valid_ids)

    def gts_for(self, ids):
        return {i: list(self.img_to_anns[i]) for i in ids}
