"""Passage corpora: the DPR Wikipedia TSV and the multi-hop QA JSON corpora
(port of :mod:`kirag_tpu.data.corpus`). The TSV loads through the C++ parser
(:mod:`kirag_tpu_torch.data.native_tsv`) where it builds, else the Python
loop.

Every corpus exposes id <-> index maps, ``get_document``, ``doc_to_str`` and
indexable items ``{"index", "passage_id", "passage"}``, the passage rendered
as ``"{title_prefix} {title}, {passage_prefix} {passage}"``.
"""

from __future__ import annotations

import logging
import os
import string
from typing import Dict, Iterator, List, Optional

from kirag_tpu_torch.utils.io import load_json

logger = logging.getLogger(__name__)

# override via env or constructor
DEFAULT_CORPUS_PATHS = {
    "wikipedia": os.environ.get("KIRAG_WIKIPEDIA_TSV", "data/wikipedia/psgs_w100.tsv"),
    "hotpotqa": os.environ.get("KIRAG_HOTPOTQA_CORPUS",
                               "data/hotpotqa/open_domain_data/corpus.json"),
    "2wikimultihopqa": os.environ.get("KIRAG_2WIKI_CORPUS",
                                      "data/2wikimultihopqa/open_domain_data/corpus.json"),
    "musique": os.environ.get("KIRAG_MUSIQUE_CORPUS",
                              "data/musique/open_domain_data/corpus.json"),
}

_PUNCTUATION = set(string.punctuation)


def _clean(text: str) -> str:
    """Strip one punctuation character from each end; collapse doubled quotes."""
    if text and text[0] in _PUNCTUATION:
        text = text[1:]
    if text and text[-1] in _PUNCTUATION:
        text = text[:-1]
    return text.replace('""', '"')


def load_psg_data(path: str, native: Optional[bool] = None):
    """Load a DPR passage TSV (``id \\t text \\t title``), skipping its header
    row and lines of fewer than three fields; text and title lose one
    punctuation character at each end, and doubled quotes become one.

    ``native=None`` tries the C++ parser (packed blobs behind lazy dict
    views, :class:`~kirag_tpu_torch.data.native_tsv.TsvPassages`; no per-row
    Python objects at 21M rows) and takes the Python loop where it does not
    build; ``native=True`` requires the parser, ``native=False`` takes the
    loop. Both give the same rows.
    """
    if native is None or native:
        try:
            from kirag_tpu_torch.data.native_tsv import load_psg_data_native

            return load_psg_data_native(path)
        except Exception as e:  # no g++, or the build failed
            if native:
                raise
            logger.info(f"native tsv parser unavailable ({e}); using the Python loader")
    data = []
    with open(path, encoding="utf-8", mode="r") as fin:
        for line in fin:
            pieces = line.strip().split("\t")
            if len(pieces) < 3:
                continue
            data.append({"id": str(pieces[0]), "title": _clean(pieces[2]),
                         "text": _clean(pieces[1])})
    return data[1:]  # first row is the "id\ttext\ttitle" header


class Corpus:
    """Base corpus: a list of passage dicts with id <-> row-index maps."""

    PASSAGE_FORMAT = "{title_prefix} {title}, {passage_prefix} {passage}"

    def __init__(self, title_prefix: str = "title:", passage_prefix: str = "context:",
                 corpus_path: Optional[str] = None, data: Optional[List[dict]] = None,
                 **kwargs):
        self.title_prefix = title_prefix
        self.passage_prefix = passage_prefix
        self.corpus_path = corpus_path
        self.kwargs = kwargs
        self.data = data if data is not None else self.load_corpus_data()
        self._pid = self.get_passage_id_name()
        pid = self._pid
        self.index_to_passage_id: Dict[int, str] = {i: ex[pid] for i, ex in enumerate(self.data)}
        self.passage_id_to_index: Dict[str, int] = {ex[pid]: i for i, ex in enumerate(self.data)}

    def load_corpus_data(self) -> List[dict]:
        raise NotImplementedError

    def get_passage_id_name(self) -> str:
        for key in self.data[0].keys():
            if "id" in key:
                return key
        raise KeyError("no id-like key in corpus records")

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[dict]:
        return (self[i] for i in range(len(self)))

    def get_document(self, passage_id: str) -> dict:
        return self.data[self.passage_id_to_index[passage_id]]

    def _passage_text(self, doc: dict) -> str:
        text = doc.get("text")
        if text is None:
            text = " ".join(sent.strip() for sent in doc["sentences"])
        return text

    def doc_to_str(self, doc: dict) -> str:
        return self.PASSAGE_FORMAT.format(
            title_prefix=self.title_prefix, title=doc["title"],
            passage_prefix=self.passage_prefix, passage=self._passage_text(doc)).strip()

    def get_document_text(self, passage_id: str) -> str:
        return self.doc_to_str(self.get_document(passage_id))

    def __getitem__(self, index: int) -> dict:
        ex = self.data[index]
        return {"index": index, "passage_id": ex[self._pid], "passage": self.doc_to_str(ex)}


class Wikipedia(Corpus):
    """DPR psgs_w100 Wikipedia TSV corpus."""

    def __init__(self, title_prefix="title:", passage_prefix="context:", corpus_path=None,
                 **kwargs):
        corpus_path = corpus_path or DEFAULT_CORPUS_PATHS["wikipedia"]
        super().__init__(title_prefix, passage_prefix, corpus_path=corpus_path, **kwargs)

    def load_corpus_data(self):
        return load_psg_data(self.corpus_path)


class JsonCorpus(Corpus):
    """A corpus.json of ``{"id", "title", "sentences"}`` records."""

    def __init__(self, title_prefix="title:", passage_prefix="context:", corpus_path=None,
                 **kwargs):
        if corpus_path is None:
            raise ValueError("corpus_path is required")
        super().__init__(title_prefix, passage_prefix, corpus_path=corpus_path, **kwargs)

    def load_corpus_data(self):
        return load_json(self.corpus_path)


class HotPotQA(JsonCorpus):
    def __init__(self, title_prefix="title:", passage_prefix="context:", corpus_path=None,
                 **kwargs):
        super().__init__(title_prefix, passage_prefix,
                         corpus_path=corpus_path or DEFAULT_CORPUS_PATHS["hotpotqa"], **kwargs)


class WikiMultiHopQA(JsonCorpus):
    def __init__(self, title_prefix="title:", passage_prefix="context:", corpus_path=None,
                 **kwargs):
        super().__init__(title_prefix, passage_prefix,
                         corpus_path=corpus_path or DEFAULT_CORPUS_PATHS["2wikimultihopqa"],
                         **kwargs)


class MuSiQue(JsonCorpus):
    def __init__(self, title_prefix="title:", passage_prefix="context:", corpus_path=None,
                 **kwargs):
        super().__init__(title_prefix, passage_prefix,
                         corpus_path=corpus_path or DEFAULT_CORPUS_PATHS["musique"], **kwargs)


CORPUS_MAP = {
    "wikipedia": Wikipedia,
    "hotpotqa": HotPotQA,
    "2wikimultihopqa": WikiMultiHopQA,
    "musique": MuSiQue,
}
