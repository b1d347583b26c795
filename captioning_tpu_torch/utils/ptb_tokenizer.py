"""Native Penn Treebank tokenizer matching Stanford PTBTokenizer output.

The reference tokenizes captions with Stanford CoreNLP 3.4.1's Java
``PTBTokenizer`` (``-preserveLines -lowerCase``) through the coco-caption
submodule (``captioning/utils/eval_utils.py:20-24``), then
drops a fixed punctuation list from the token stream (coco-caption
``tokenizer.py`` PUNCTUATIONS).  Every language_eval number flows through
that tokenization, so comparability with the reference's MODEL_ZOO.md
scores requires matching its token *boundaries* exactly — in particular:

* contraction splitting:  ``don't`` -> ``do n't``, ``it's`` -> ``it 's``,
  ``cannot`` -> ``can not``, ``gonna`` -> ``gon na``
* possessives:  ``man's`` -> ``man 's``, ``dogs'`` -> ``dogs '``
* hyphenated words stay whole:  ``well-known`` is ONE token
* number-internal punctuation stays:  ``1,000``, ``3.5``, ``5:30``
* bracket normalization:  ``(`` -> ``-LRB-`` etc. (then dropped by the
  punctuation filter)
* currency/percent split:  ``$5`` -> ``$ 5``, ``50%`` -> ``50 %``

This is a from-scratch port of the PTB tokenization conventions (Robert
MacIntyre's ``tokenizer.sed`` as extended by Stanford's PTBLexer defaults:
``normalizeParentheses``, ``ptb3Ellipsis``, ``ptb3Dashes``,
``latexQuotes``).  Deliberate, metric-neutral divergences from the Java
lexer (documented in PARITY.md):

* no ``\\/`` forward-slash escaping (``escapeForwardSlashAsterisk``):
  token boundaries are identical, and hypotheses and references pass
  through the same tokenizer, so every overlap metric is unchanged;
* no ``americanize`` spelling normalization (affects token content for a
  handful of British spellings, again symmetric across hyp/ref);
* no sentence-final abbreviation period duplication (the duplicated ``.``
  is in the dropped-punctuation list either way).
"""

from __future__ import annotations

import re
from typing import List

# Unicode normalization (PTBLexer latexQuotes / ptb3Ellipsis / ptb3Dashes)
_UNICODE_MAP = [
    ('‘', "'"), ('’', "'"), ('“', '"'), ('”', '"'),
    ('–', '--'), ('—', '--'), ('…', '...'),
    (' ', ' '),
]

_STARTING_QUOTES = [
    (re.compile(r'^\"'), r'``'),
    (re.compile(r'(``)'), r' \1 '),
    (re.compile(r'([ (\[{<])(\"|\'{2})'), r'\1 `` '),
]

_PUNCTUATION = [
    # at / hash are their own tokens; ampersand too unless word-internal
    # (the Java lexer keeps at&t whole)
    (re.compile(r'([@#])'), r' \1 '),
    (re.compile(r'(?<![A-Za-z0-9])&|&(?![A-Za-z0-9])'), r' & '),
    # currency sign splits off the front of a number/word
    (re.compile(r'(\$)'), r' \1 '),
    # percent splits off the back
    (re.compile(r'(%)'), r' \1 '),
    # comma: split unless flanked by digits (1,000 stays)
    (re.compile(r'([^\d]),'), r'\1 , '),
    (re.compile(r',([^\d])'), r' , \1'),
    (re.compile(r',$'), r' ,'),
    # colon: split unless flanked by digits (5:30 stays)
    (re.compile(r'([^\d]):'), r'\1 : '),
    (re.compile(r':([^\d])'), r' : \1'),
    (re.compile(r':$'), r' :'),
    # ellipsis
    (re.compile(r'\.\.\.'), r' ... '),
    # semicolon always splits
    (re.compile(r';'), r' ; '),
    # question/exclamation always split
    (re.compile(r'([?!])'), r' \1 '),
    # sentence-final period: split off unless the word is an abbreviation
    # (contains an internal period, e.g. u.s.) — handled token-wise below
]

_BRACKETS = [
    (re.compile(r'\('), ' -LRB- '), (re.compile(r'\)'), ' -RRB- '),
    (re.compile(r'\['), ' -LSB- '), (re.compile(r'\]'), ' -RSB- '),
    (re.compile(r'\{'), ' -LCB- '), (re.compile(r'\}'), ' -RCB- '),
]

_DOUBLE_DASH = (re.compile(r'--'), r' -- ')

# closing double quotes become their own '' token before the word pass
_CLOSING_DQUOTE = (re.compile(r'"'), " '' ")

# possessive / contraction clitics (the Java lexer is case-insensitive)
_CLITICS = [
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

# CONTRACTIONS2/3 from tokenizer.sed (Stanford splits the same set)
_CONTRACTIONS2 = [re.compile(p, re.IGNORECASE) for p in (
    r"\b(can)(not)\b", r"\b(d)('ye)\b", r"\b(gim)(me)\b", r"\b(gon)(na)\b",
    r"\b(got)(ta)\b", r"\b(lem)(me)\b", r"\b(more)('n)\b", r"\b(wan)(na)\b",
)]
_CONTRACTIONS3 = [re.compile(p, re.IGNORECASE) for p in (
    r" ('t)(is)\b", r" ('t)(was)\b",
)]

# a token counts as an abbreviation (final period kept) when it has an
# internal period: u.s., d.c., a.m.  Single letters with a period (initials)
# also keep it mid-sentence; PTB splits the final sentence period only.
_ABBREV_RE = re.compile(r"^([a-zA-Z]\.)+[a-zA-Z]?\.?$|^[a-zA-Z]\.$")

# common abbreviation words whose period stays attached (subset of the
# Java lexer's lexicon that can plausibly appear in captions)
_ABBREV_WORDS = frozenset(
    'mr mrs ms dr prof st ave blvd rd mt ft no vs etc inc ltd co corp '
    'jr sr jan feb mar apr jun jul aug sep sept oct nov dec'.split())

# tokens that pass through the word pass untouched
_PASSTHROUGH = frozenset(["``", "''", '...', '--', '.', "'", '`'])


def _split_final_period(tok: str) -> List[str]:
    """PTB splits one sentence-final period off a word; abbreviation
    periods stay attached (mr., u.s.).  Interior decimal points survive
    because only the single trailing period is split ("3.5." -> "3.5 .")."""
    if not tok.endswith('.') or len(tok) == 1 or set(tok) == {'.'}:
        return [tok]
    body = tok[:-1]
    if _ABBREV_RE.match(tok) or body.lower() in _ABBREV_WORDS:
        return [tok]
    # any letter-word with an internal period is an abbreviation (ph.d.,
    # u.s.a.); the Java lexer's ABBREV3 pattern keeps its final period.
    # Digit-bearing tokens (3.5.) are numbers, not abbreviations: split.
    if '.' in body and not any(c.isdigit() for c in tok):
        return [tok]
    return [body, '.']


def ptb_word_tokenize(text: str) -> List[str]:
    """Tokenize one line the way ``java PTBTokenizer -preserveLines``
    does (before any lowercasing or punctuation filtering)."""
    for src, dst in _UNICODE_MAP:
        text = text.replace(src, dst)
    text = ' ' + text.strip() + ' '

    for pat, sub in _STARTING_QUOTES:
        text = pat.sub(sub, text)
    text = _CLOSING_DQUOTE[0].sub(_CLOSING_DQUOTE[1], text)
    text = _DOUBLE_DASH[0].sub(_DOUBLE_DASH[1], text)
    for pat, sub in _BRACKETS:
        text = pat.sub(sub, text)
    for pat, sub in _PUNCTUATION:
        text = pat.sub(sub, text)

    # word pass: opening single quotes (latexQuotes: ' -> `), sentence-final
    # periods, trailing possessive quotes
    toks: List[str] = []
    for tok in text.split():
        if tok in _PASSTHROUGH:
            toks.append(tok)
            continue
        while len(tok) > 1 and tok[0] == "'" and tok[1] != "'" and \
                not re.match(r"^'(tis|twas|em|til|cause)\b", tok,
                             re.IGNORECASE):
            toks.append('`')
            tok = tok[1:]
        # trailing single quote first (dogs'. -> dogs ' .): peel quotes and
        # periods outside-in
        pending: List[str] = []
        while len(tok) > 1:
            if tok.endswith("'") and not re.search(
                    r"(n't|'[smd]|'ll|'re|'ve)$", tok, re.IGNORECASE):
                pending.append("'")
                tok = tok[:-1]
                continue
            pieces = _split_final_period(tok)
            if len(pieces) == 1:
                break
            tok = pieces[0]
            pending.append(pieces[1])
        toks.append(tok)
        toks.extend(reversed(pending))

    # clitic pass over the rejoined stream (every clitic now has a
    # following space): don't -> do n't, man's -> man 's
    text = ' ' + ' '.join(toks) + ' '
    for pat, sub in _CLITICS:
        text = pat.sub(sub, text)
    for pat in _CONTRACTIONS2:
        text = pat.sub(r' \1 \2 ', text)
    for pat in _CONTRACTIONS3:
        text = pat.sub(r' \1 \2 ', text)
    return text.split()


# coco-caption tokenizer.py PUNCTUATIONS — tokens removed from the stream
PUNCTUATIONS = frozenset([
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
])
# coco-caption's list omits the square-bracket forms; the Java pipeline
# leaves -LSB-/-RSB- in the stream.  Match that (brackets never appear in
# COCO captions anyway).


def ptb_tokenize(caption: str) -> str:
    """Full coco-caption tokenization: PTB tokenize, lowercase
    (``-lowerCase``), drop the PUNCTUATIONS tokens, re-join."""
    toks = [t.lower() for t in ptb_word_tokenize(caption)]
    return ' '.join(t for t in toks if t not in PUNCTUATIONS)
