"""QA and retrieval metrics (port of :mod:`kirag_tpu.evaluation.metrics`).

- ``normalize_answer``: lowercase, strip punctuation and articles, squeeze
  whitespace.
- ``f1_score``: token F1 with the yes/no/noanswer guard; returns (f1,
  precision, recall).
- ``has_answer``: DPR-style answer presence, by unicode word tokens and a
  sliding-window match (answer recall@k on datasets without qrels).

The reference tokenizes with the third-party ``regex`` package
(``[\\p{L}\\p{N}\\p{M}]+|[^\\p{Z}\\p{C}]``). The port classifies characters
with :mod:`unicodedata` instead, which gives the same tokens wherever
Python's Unicode tables agree with that package's, and ``regex_match``
compiles answer patterns with the standard :mod:`re` (see there).
"""

from __future__ import annotations

import re
import string
import unicodedata
from collections import Counter
from typing import List, Tuple

_PUNCT = set(string.punctuation)
_ARTICLE_RE = re.compile(r"\b(a|an|the)\b")


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNCT)
    s = _ARTICLE_RE.sub(" ", s)
    return " ".join(s.split())


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def ems(prediction: str, ground_truths: List[str]) -> bool:
    return max(exact_match_score(prediction, gt) for gt in ground_truths)


def f1_score(prediction: str, ground_truth: str) -> Tuple[float, float, float]:
    norm_pred = normalize_answer(prediction)
    norm_gold = normalize_answer(ground_truth)

    zero = (0.0, 0.0, 0.0)
    special = ("yes", "no", "noanswer")
    if norm_pred in special and norm_pred != norm_gold:
        return zero
    if norm_gold in special and norm_pred != norm_gold:
        return zero

    pred_tokens = norm_pred.split()
    gold_tokens = norm_gold.split()
    common = Counter(pred_tokens) & Counter(gold_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return zero
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gold_tokens)
    f1 = 2 * precision * recall / (precision + recall)
    return f1, precision, recall


def _nfd(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def _tokenize_words(text: str) -> List[str]:
    """Lower-cased tokens: each run of letters, numbers and marks (Unicode
    categories L, N, M) is one token, and every other character outside
    the separators (Z) and the others (C: controls, formats, unassigned)
    is a token of its own."""
    tokens: List[str] = []
    word: List[str] = []
    for ch in text:
        kind = unicodedata.category(ch)[0]
        if kind in "LNM":
            word.append(ch)
            continue
        if word:
            tokens.append("".join(word).lower())
            word = []
        if kind not in "ZC":
            tokens.append(ch.lower())
    if word:
        tokens.append("".join(word).lower())
    return tokens


def regex_match(text: str, pattern: str) -> bool:
    """True when ``pattern`` (case-insensitive, multiline) matches somewhere
    in ``text``; False for a pattern that does not compile. Patterns are
    compiled by the standard :mod:`re`, not the reference's ``regex``
    package: the syntax that only ``regex`` knows (``\\p{..}`` property
    classes, POSIX classes, nested sets, fuzzy matching) does not compile
    here, so such a pattern gives False where the reference may match."""
    try:
        compiled = re.compile(pattern, flags=re.IGNORECASE | re.UNICODE | re.MULTILINE)
    except re.error:
        return False
    return compiled.search(text) is not None


def has_answer(answers: List[str], text: str, match_type: str = "string") -> bool:
    """True when ``text`` contains any answer as a token subsequence
    (``string``) or matches any answer pattern (``regex``)."""
    text = _nfd(text)
    if match_type == "string":
        words = _tokenize_words(text)
        for answer in answers:
            answer_words = _tokenize_words(_nfd(answer))
            if not answer_words:
                continue
            for i in range(len(words) - len(answer_words) + 1):
                if words[i: i + len(answer_words)] == answer_words:
                    return True
    elif match_type == "regex":
        for answer in answers:
            if regex_match(text, _nfd(answer)):
                return True
    return False
