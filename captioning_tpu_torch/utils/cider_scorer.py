"""CIDEr-D / CIDEr / BLEU scorers, reimplemented from scratch.

The reference consumes these from the ``cider`` and ``coco-caption``
submodules (``captioning/utils/rewards.py:11-16``); they are
rebuilt here natively with identical semantics:

* CIDEr-D (Vedantam et al.): tf-idf over 1..4-grams where
  ``tfidf = tf * (log(N_refs) - log(max(df, 1)))``, clipped candidate
  counts (min(h, r) . r), per-n cosine normalization, gaussian length
  penalty ``exp(-(len_h - len_r)^2 / (2*sigma^2))`` with sigma=6, averaged
  over refs and n, scaled by 10.
* the doc-frequency cache format written by scripts/prepro_ngrams.py
  (``{'document_frequency': {ngram_tuple: df}, 'ref_len': N}``, reference
  prepro_ngrams.py:77-80) is loaded directly.
* sentences are space-joined token strings (id-strings for SCST,
  reference rewards.py:33-39); the terminal 0/<eos> token is part of the
  n-gram stream.
* BLEU mirrors coco-caption's BleuScorer: per-image scores with
  tiny/small smoothing and 'closest' ref-length brevity penalty.

All scorers expose ``compute_score(gts, res)`` with the reference's
calling conventions so utils/rewards.py is a drop-in.
"""

from __future__ import annotations

import math
import pickle
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def precook(s: str, n: int = 4) -> Tuple[int, Dict[tuple, int]]:
    """Count n-grams of a space-separated sentence."""
    words = s.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return len(words), dict(counts)


class CiderBase:
    def __init__(self, df='corpus', n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        self.df_mode = 'corpus' if df == 'corpus' else 'cached'
        self.document_frequency = None
        self.ref_len = None
        if self.df_mode == 'cached':
            path = df if df.endswith(('.p', '.pkl')) else 'data/%s.p' % df
            with open(path, 'rb') as f:
                pkl = pickle.load(f, encoding='latin-1')
            self.document_frequency = dict(pkl['document_frequency'])
            self.ref_len = np.log(float(pkl['ref_len']))

    # -- vectors ---------------------------------------------------------
    def _counts2vec(self, counts: Dict[tuple, int]):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, term_freq in counts.items():
            df = math.log(max(1.0, self.document_frequency.get(ngram, 0.0)))
            k = len(ngram) - 1
            vec[k][ngram] = float(term_freq) * (self.ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += term_freq
        norm = [math.sqrt(x) for x in norm]
        return vec, norm, length

    def _compute_df_corpus(self, crefs):
        self.document_frequency = defaultdict(float)
        for refs in crefs:
            for ngram in set(ng for ref in refs for ng in ref[1].keys()):
                self.document_frequency[ngram] += 1
        self.ref_len = np.log(float(len(crefs)))


class CiderD(CiderBase):
    """CIDEr-D with clipping and length gaussian (pyciderevalcap ciderD)."""

    def _sim(self, vec_h, vec_r, norm_h, norm_r, len_h, len_r):
        delta = float(len_h - len_r)
        val = np.zeros(self.n)
        for k in range(self.n):
            s = 0.0
            vr = vec_r[k]
            for ngram, h in vec_h[k].items():
                r = vr.get(ngram, 0.0)
                s += min(h, r) * r
            if norm_h[k] != 0 and norm_r[k] != 0:
                s /= (norm_h[k] * norm_r[k])
            val[k] = s * math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    def compute_score(self, gts: Dict, res: List[Dict]):
        """gts: {id: [ref strings]}; res: [{'image_id': id, 'caption': [s]}].
        Returns (mean_score, per_image_scores ndarray)."""
        crefs, ctest, ids = [], [], []
        for ent in res:
            i = ent['image_id']
            ids.append(i)
            ctest.append(precook(ent['caption'][0], self.n))
            crefs.append([precook(r, self.n) for r in gts[i]])
        if self.df_mode == 'corpus' or self.document_frequency is None:
            self._compute_df_corpus(crefs)
        # SCST scores seq_per_img+1 candidates against the SAME refs (the
        # id repeats, rewards.py:41-81): tf-idf-vectorize each image's
        # references once, not once per candidate row
        ref_vec_cache: Dict = {}
        scores = []
        for i, ((tlen, tcounts), refs) in enumerate(zip(ctest, crefs)):
            vec, norm, length = self._counts2vec(tcounts)
            rv = ref_vec_cache.get(ids[i])
            if rv is None:
                rv = [self._counts2vec(rcounts) for rlen, rcounts in refs]
                ref_vec_cache[ids[i]] = rv
            score = np.zeros(self.n)
            for vec_r, norm_r, length_r in rv:
                score += self._sim(vec, vec_r, norm, norm_r, length, length_r)
            score_avg = np.mean(score) / len(refs) * 10.0
            scores.append(score_avg)
        scores = np.array(scores)
        return float(scores.mean()), scores


class Cider(CiderBase):
    """Plain CIDEr (no clipping, no length gaussian) + my_self_cider."""

    def _sim(self, vec_h, vec_r, norm_h, norm_r):
        val = np.zeros(self.n)
        for k in range(self.n):
            s = 0.0
            vr = vec_r[k]
            for ngram, h in vec_h[k].items():
                s += h * vr.get(ngram, 0.0)
            if norm_h[k] != 0 and norm_r[k] != 0:
                s /= (norm_h[k] * norm_r[k])
            val[k] = s
        return val

    def compute_score(self, gts: Dict, res: List[Dict]):
        crefs, ctest, ids = [], [], []
        for ent in res:
            i = ent['image_id']
            ids.append(i)
            ctest.append(precook(ent['caption'][0], self.n))
            crefs.append([precook(r, self.n) for r in gts[i]])
        if self.df_mode == 'corpus' or self.document_frequency is None:
            self._compute_df_corpus(crefs)
        scores = []
        for (tlen, tcounts), refs in zip(ctest, crefs):
            vec, norm, _ = self._counts2vec(tcounts)
            score = np.zeros(self.n)
            for rlen, rcounts in refs:
                vec_r, norm_r, _ = self._counts2vec(rcounts)
                score += self._sim(vec, vec_r, norm, norm_r)
            scores.append(np.mean(score) / len(refs) * 10.0)
        scores = np.array(scores)
        return float(scores.mean()), scores

    def my_self_cider(self, res: List[List[str]]):
        """Gram matrix of tf-idf similarity among candidate sentences
        (cider submodule my_self_cider; consumed by
        reference rewards.py:116-135)."""
        if self.document_frequency is None:
            raise RuntimeError('self-cider needs a cached df')
        out = []
        for sents in res:
            cooked = [precook(s, self.n) for s in sents]
            vecs = [self._counts2vec(c[1]) for c in cooked]
            m = len(sents)
            G = np.zeros((m, m))
            for i in range(m):
                for j in range(m):
                    G[i, j] = np.mean(self._sim(
                        vecs[i][0], vecs[j][0], vecs[i][1], vecs[j][1])) * 10.0
            out.append(G)
        return out


class Bleu:
    """coco-caption-style BLEU (per-image, closest-length BP, tiny/small
    smoothing)."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict):
        small = 1e-9
        tiny = 1e-15
        ids = list(res.keys())  # callers pass dicts (see rewards.py)
        per_n_scores = [[] for _ in range(self.n)]
        total_correct = np.zeros(self.n)
        total_guess = np.zeros(self.n)
        total_testlen = 0
        total_reflen = 0
        for i in ids:
            hyp = res[i][0].split()
            refs = [r.split() for r in gts[i]]
            testlen = len(hyp)
            # closest ref length
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
            correct = np.zeros(self.n)
            guess = np.zeros(self.n)
            for k in range(1, self.n + 1):
                hcounts: Dict[tuple, int] = defaultdict(int)
                for j in range(len(hyp) - k + 1):
                    hcounts[tuple(hyp[j:j + k])] += 1
                rmax: Dict[tuple, int] = defaultdict(int)
                for r in refs:
                    rc: Dict[tuple, int] = defaultdict(int)
                    for j in range(len(r) - k + 1):
                        rc[tuple(r[j:j + k])] += 1
                    for ng, c in rc.items():
                        rmax[ng] = max(rmax[ng], c)
                guess[k - 1] = max(len(hyp) - k + 1, 0)
                correct[k - 1] = sum(min(c, rmax[ng])
                                     for ng, c in hcounts.items())
            total_correct += correct
            total_guess += guess
            total_testlen += testlen
            total_reflen += reflen
            # per-image score
            bleu = 1.0
            for k in range(self.n):
                bleu *= (correct[k] + tiny) / (guess[k] + small)
                score_k = bleu ** (1.0 / (k + 1))
                ratio = (testlen + tiny) / (reflen + small)
                if ratio < 1:
                    score_k *= math.exp(1 - 1 / ratio)
                per_n_scores[k].append(score_k)
        # corpus score
        corpus = []
        bleu = 1.0
        ratio = (total_testlen + tiny) / (total_reflen + small)
        for k in range(self.n):
            bleu *= (total_correct[k] + tiny) / (total_guess[k] + small)
            score_k = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                score_k *= math.exp(1 - 1 / ratio)
            corpus.append(score_k)
        return corpus, per_n_scores
