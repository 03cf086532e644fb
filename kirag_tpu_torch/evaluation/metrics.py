"""QA metrics that the KiRAG loop uses (port of the SQuAD normalization and
the HotPotQA token-F1 of :mod:`kirag_tpu.evaluation.metrics`).

- ``normalize_answer``: lowercase, strip punctuation and articles, squeeze
  whitespace.
- ``f1_score``: token F1 with the yes/no/noanswer guard; returns (f1,
  precision, recall).
"""

from __future__ import annotations

import re
import string
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
