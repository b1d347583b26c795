"""n-gram distinctness ratios for multi-caption diversity evaluation.

The port's copy of ``captioning_tpu/utils/div_utils.py`` (the reference's
``captioning/utils/div_utils.py`` semantics):

* ``compute_div_n``: per image, |unique n-grams| / total tokens, averaged
  over images (Div-1/Div-2 in the diversity paper).
* ``compute_global_div_n``: pooled over ALL images' captions; for n == 1
  the raw unique-unigram COUNT is reported (the reference's gDiv-1
  convention), otherwise the pooled ratio.
"""

import numpy as np


def _ngram_set_and_len(captions, n):
    """Unique n-gram tuples and total token count over a caption list."""
    grams = set()
    n_tokens = 0
    for caption in captions:
        toks = caption.split()
        n_tokens += len(toks)
        grams.update(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))
    return grams, n_tokens


def compute_div_n(caps, n=1):
    ratios = []
    for image_id in caps:
        grams, n_tokens = _ngram_set_and_len(caps[image_id], n)
        ratios.append(len(grams) / (1e-6 + n_tokens))
    ratios = np.asarray(ratios, dtype=np.float64)
    return ratios.mean(), ratios


def compute_global_div_n(caps, n=1):
    all_caps = [c for image_id in caps for c in caps[image_id]]
    grams, n_tokens = _ngram_set_and_len(all_caps, n)
    score = float(len(grams)) if n == 1 else len(grams) / (1e-6 + n_tokens)
    return score, np.full(len(caps), score, dtype=np.float64)
