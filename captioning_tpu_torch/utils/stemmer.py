"""Porter stemmer (classic 1980 algorithm), dependency-free.

Backs the stem-match stage of the native METEOR approximation in
``coco_eval.py`` (the reference's Java METEOR 1.5 uses a Snowball English
stemmer for its second matcher stage; Porter is its direct ancestor and
agrees on the vast majority of caption vocabulary).
"""

from __future__ import annotations

_VOWELS = 'aeiou'


def _is_consonant(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == 'y':
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences ("measure" m in Porter's paper)."""
    forms = ''.join('c' if _is_consonant(stem, i) else 'v'
                    for i in range(len(stem)))
    return forms.count('vc')


def _has_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in 'wxy')


def _replace(word: str, suffix: str, repl: str, m_min: int) -> str:
    stem = word[:len(word) - len(suffix)]
    if _measure(stem) > m_min:
        return stem + repl
    return word


_STEP2 = [('ational', 'ate'), ('tional', 'tion'), ('enci', 'ence'),
          ('anci', 'ance'), ('izer', 'ize'), ('abli', 'able'),
          ('alli', 'al'), ('entli', 'ent'), ('eli', 'e'), ('ousli', 'ous'),
          ('ization', 'ize'), ('ation', 'ate'), ('ator', 'ate'),
          ('alism', 'al'), ('iveness', 'ive'), ('fulness', 'ful'),
          ('ousness', 'ous'), ('aliti', 'al'), ('iviti', 'ive'),
          ('biliti', 'ble')]

_STEP3 = [('icate', 'ic'), ('ative', ''), ('alize', 'al'), ('iciti', 'ic'),
          ('ical', 'ic'), ('ful', ''), ('ness', '')]

_STEP4 = ['al', 'ance', 'ence', 'er', 'ic', 'able', 'ible', 'ant', 'ement',
          'ment', 'ent', 'ou', 'ism', 'ate', 'iti', 'ous', 'ive', 'ize']


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word

    # Step 1a
    if w.endswith('sses'):
        w = w[:-2]
    elif w.endswith('ies'):
        w = w[:-2]
    elif w.endswith('ss'):
        pass
    elif w.endswith('s'):
        w = w[:-1]

    # Step 1b
    if w.endswith('eed'):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith('ed') and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith('ing') and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(('at', 'bl', 'iz')):
                w += 'e'
            elif _ends_double_consonant(w) and w[-1] not in 'lsz':
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += 'e'

    # Step 1c
    if w.endswith('y') and _has_vowel(w[:-1]):
        w = w[:-1] + 'i'

    # Step 2
    for suffix, repl in _STEP2:
        if w.endswith(suffix):
            w = _replace(w, suffix, repl, 0)
            break

    # Step 3
    for suffix, repl in _STEP3:
        if w.endswith(suffix):
            w = _replace(w, suffix, repl, 0)
            break

    # Step 4
    for suffix in _STEP4:
        if w.endswith(suffix):
            if suffix == 'ion':
                continue
            stem = w[:len(w) - len(suffix)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith('ion') and len(w) > 3 and w[-4] in 'st':
            if _measure(w[:-3]) > 1:
                w = w[:-3]

    # Step 5a
    if w.endswith('e'):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith('l'):
        w = w[:-1]

    return w
