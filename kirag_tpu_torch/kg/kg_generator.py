"""KGGenerator: LLM-based document -> knowledge-triple extraction with caching
(port of :mod:`kirag_tpu.kg.kg_generator`).

Mirrors the reference `KGGenerator` (`knowledge_graph/kg_generator.py`):
- the same task instruction and few-shot prompting with per-document examplar
  ranking by embedding similarity (:106-123), done here through an injected
  ``embedder`` (any object with ``calculate_document_embeddings``) instead of
  the reference's module-global second E5 copy (`retriever/e5.py`);
- context-window-aware examplar dropping (:150-166);
- ``<h; r; t>`` parsing and sentence attribution (:227-245);
- a pickle triple cache keyed by doc id (:125-143), so triples for a document
  are extracted once per corpus.
"""

from __future__ import annotations

import logging
import os
import pickle
from copy import deepcopy
from typing import Dict, List, Optional, Union

import numpy as np

from kirag_tpu_torch.kg.triples import find_sentence_for_triple, parse_triples_text

logger = logging.getLogger(__name__)

EXAMPLAR_TYPES = ("hotpotqa", "2wikimultihopqa", "musique", "nq", "tqa",
                  "webqa", "bamboogle", "wikipedia")

TASK_INSTRUCTION = (
    "You are a knowledge graph constructor tasked with extracting knowledge triples "
    "in the form of <head entity; relation; tail entity> from a document. "
    "Each triple denotes a specific relationship between entities or an event. "
    "The head entity and tail entity can be the provided title or phrases in the text. "
    "If multiple tail entities share the same relation with a head entity, "
    "aggregate these tail entities using commas. "
    "Format your output in the form of <head entity; relation; tail entity>."
)


def document_to_text(doc: Dict) -> str:
    """"Title: {t}\\nText: {x}" rendering (reference `kg_generator.py:78-97`)."""
    text = doc.get("text")
    if text is None:
        text = " ".join(sent.strip() for sent in doc["sentences"])
    return "Title: {}\nText: {}".format(doc["title"], text)


def load_examplars(examplar_type: str) -> List[Dict]:
    """Dataset-specific few-shot examplars (original demonstrations live in
    ``kirag_tpu_torch.prompts``; dispatch mirrors `kg_generator.py:56-74`)."""
    if examplar_type not in EXAMPLAR_TYPES:
        raise KeyError(f"{examplar_type} is not a supported examplar type!")
    from kirag_tpu_torch.prompts import kg_construction

    if examplar_type == "hotpotqa":
        return kg_construction.HOTPOTQA_EXAMPLARS
    if examplar_type == "2wikimultihopqa":
        return kg_construction.WIKIMULTIHOPQA_EXAMPLARS
    if examplar_type == "musique":
        return kg_construction.MUSIQUE_EXAMPLARS
    return kg_construction.WIKIPEDIA_EXAMPLARS


class KGGenerator:
    def __init__(self, generator, examplar_type: str = "hotpotqa", num_examplars: int = 5,
                 adaptive_examplars: bool = True, embedder=None,
                 examplars: Optional[List[Dict]] = None, max_length: int = 4096,
                 max_new_tokens: int = 512, batch_size: int = 4, verbose: bool = False,
                 **kwargs):
        self.generator = generator  # kirag_tpu_torch.generation.Generator
        self.tokenizer = generator.tokenizer
        self.max_length = max_length
        self.max_new_tokens = max_new_tokens
        self.num_examplars = num_examplars
        self.adaptive_examplars = adaptive_examplars and embedder is not None
        self.embedder = embedder
        self.examplars = examplars if examplars is not None else load_examplars(examplar_type)
        self.batch_size = batch_size
        self.verbose = verbose
        self.cached_kg_triples: Optional[Dict[str, Dict]] = None
        self.task_instruction = TASK_INSTRUCTION
        self.kwargs = kwargs

        self.examplars_embeddings = None
        if self.adaptive_examplars:
            texts = [document_to_text(e) for e in self.examplars]
            self.examplars_embeddings = np.asarray(
                self.embedder.calculate_document_embeddings(texts, max_length=256))

    # -- examplar ranking -------------------------------------------------------

    def rank_examplars(self, documents: List[Dict]) -> List[Dict]:
        """Attach 'ranked_examplars_indices' per doc by embedding similarity
        (reference `kg_generator.py:106-123`)."""
        if not self.adaptive_examplars:
            return documents
        texts = [document_to_text(d) for d in documents]
        emb = np.asarray(self.embedder.calculate_document_embeddings(texts, max_length=256))
        sims = emb @ self.examplars_embeddings.T
        for doc, row in zip(documents, np.argsort(-sims, axis=1, kind="stable")):
            doc["ranked_examplars_indices"] = row.tolist()
        return documents

    # -- cache -------------------------------------------------------------------

    def load_cached_kg_triples(self, paths: Union[str, List[str]]) -> None:
        if isinstance(paths, str):
            paths = [paths]
        if self.cached_kg_triples is None:
            logger.info("Initializing a new KG triples cache ...")
            self.cached_kg_triples = {}
        for path in paths:
            if os.path.exists(path):
                logger.info(f"loading cached KG triples from {path} ...")
                with open(path, "rb") as f:
                    self.cached_kg_triples.update(pickle.load(f))

    def save_cached_kg_triples(self, path: str) -> None:
        if self.cached_kg_triples is not None:
            logger.info(f"saving cached KG triples to {path} ...")
            with open(path, "wb") as f:
                pickle.dump(self.cached_kg_triples, f)

    # -- prompting ---------------------------------------------------------------

    def _examplar_text(self, examplar: Dict) -> str:
        return "{}\nKnowledge Triples: {}".format(document_to_text(examplar), examplar["triples"])

    def _fit_examplars_to_context(self, examplars: List[str], doc: Dict) -> List[str]:
        """Drop examplars until the prompt fits max_length
        (reference `kg_generator.py:150-166`)."""
        doc_text = document_to_text(doc)
        while examplars:
            for num in range(len(examplars), 0, -1):
                prompt = self.task_instruction + "\n\n" + "\n\n".join(examplars[:num]) \
                    + "\n\n" + doc_text
                if len(self.tokenizer.encode(prompt)) <= self.max_length:
                    return examplars[:num]
            examplars = examplars[1:]
        return []

    def get_documents_inputs(self, documents: List[Dict]):
        instructions, inputs = [], []
        for doc in documents:
            ranked = doc.get("ranked_examplars_indices") or list(range(len(self.examplars)))
            chosen = [self._examplar_text(self.examplars[i]) for i in ranked[: self.num_examplars]]
            chosen = self._fit_examplars_to_context(chosen, doc)
            instructions.append(self.task_instruction + "\n\n" + "\n\n".join(chosen))
            inputs.append(document_to_text(doc))
        return instructions, inputs

    # -- generation -----------------------------------------------------------------

    def parse_triples_text(self, text: str) -> List[str]:
        return parse_triples_text(text)

    def parse_generator_outputs(self, documents: List[Dict], outputs: List[str]) -> List[Dict]:
        for doc, generated in zip(documents, outputs):
            triples = []
            for one_triple in parse_triples_text(generated):
                sentence = find_sentence_for_triple(doc, one_triple)
                triples.append({"text": one_triple, "sentence": sentence})
            doc["triples"] = triples
        return documents

    def generate_kg_triples_wo_cache(self, documents: Union[Dict, List[Dict]]):
        is_list = isinstance(documents, list)
        if not is_list:
            documents = [documents]
        documents = self.rank_examplars(documents)

        generated: List[str] = []
        for start in range(0, len(documents), self.batch_size):
            batch = documents[start: start + self.batch_size]
            instructions, inputs = self.get_documents_inputs(batch)
            texts = self.generator.generate_texts(
                instructions, inputs, max_new_tokens=self.max_new_tokens)
            generated.extend(texts)

        documents = self.parse_generator_outputs(documents, generated)
        return documents if is_list else documents[0]

    def generate_kg_triples_with_cache(self, documents: Union[Dict, List[Dict]]):
        assert self.cached_kg_triples is not None, \
            "use load_cached_kg_triples(path) to load or initialize the KG cache first"
        is_list = isinstance(documents, list)
        if not is_list:
            documents = [documents]
        all_docids = [doc["id"] for doc in documents]
        missing = deepcopy([doc for docid, doc in zip(all_docids, documents)
                            if docid not in self.cached_kg_triples])
        if missing:
            docs_with_kgs = self.generate_kg_triples_wo_cache(missing)
            self.cached_kg_triples.update({doc["id"]: doc for doc in docs_with_kgs})
        out = [self.cached_kg_triples[docid] for docid in all_docids]
        return out if is_list else out[0]

    def __call__(self, documents: Union[Dict, List[Dict]]):
        if self.cached_kg_triples is None:
            return self.generate_kg_triples_wo_cache(documents)
        return self.generate_kg_triples_with_cache(documents)
