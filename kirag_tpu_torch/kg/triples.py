"""Knowledge-triple text utilities: parsing, sentence attribution, splitting
(port of :mod:`kirag_tpu.kg.triples`).

Mirrors the parsing layer of the reference KGGenerator
(`knowledge_graph/kg_generator.py:227-245`): triples are extracted from LLM
output as ``<head; relation; tail>`` spans and attributed to the source
sentence with the maximum common-word count.
"""

from __future__ import annotations

import re
from typing import Dict, List, Union

_TRIPLE_RE = re.compile(r"<([^>]*)>")
# abbreviation-aware fallback splitter used when nltk punkt data is absent
_SENT_RE = re.compile(r"(?<!\b[A-Z])(?<!\bMr)(?<!\bMrs)(?<!\bDr)(?<!\bSt)(?<=[.!?])\s+")


def sent_tokenize(text: str) -> List[str]:
    """Sentence-split via nltk punkt when its data is installed, else a
    regex fallback (this environment cannot download punkt_tab)."""
    try:
        import nltk

        nltk.data.find("tokenizers/punkt_tab")
        from nltk.tokenize import sent_tokenize as nltk_sent

        return nltk_sent(text)
    except LookupError:
        pass
    except ImportError:  # pragma: no cover
        pass
    parts = [s.strip() for s in _SENT_RE.split(text) if s.strip()]
    return parts if parts else [text]


def parse_triples_text(triples_text: str) -> List[str]:
    """Extract ``<...>`` spans, dropping template placeholders
    (reference `kg_generator.py:227-233`)."""
    results = []
    for inner in _TRIPLE_RE.findall(triples_text):
        if "head entity" in inner or "tail entity" in inner:
            continue
        results.append("<{}>".format(inner.strip()))
    return results


def find_sentence_for_triple(doc: Dict[str, Union[str, List[str]]], triple: str) -> int:
    """Index of the doc sentence sharing the most words with the triple
    (reference `kg_generator.py:235-245`)."""
    sentences = doc.get("sentences")
    if sentences is None:
        sentences = sent_tokenize(doc["text"])
    counts = [sum(word in sentence for word in triple.split()) for sentence in sentences]
    return int(max(range(len(counts)), key=counts.__getitem__)) if counts else 0


def triple_to_sentence(triple: str) -> str:
    """`<h; r; t>` -> "h r t" (reference `utils/utils.py:215-230`)."""
    return triple.replace("<", "").replace(">", "").replace(";", "", 2)
