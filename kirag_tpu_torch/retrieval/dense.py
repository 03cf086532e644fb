"""DenseRetriever: encoder + collator + device index + corpus facade (port of
:class:`kirag_tpu.retrieval.dense.DenseRetriever`).

Retrieval is encode -> search on the index's device (exact, or the
group-sampled approximate search under ``search_mode="approx"``) -> id join
with the corpus. Texts are embedded ``batch_size`` at a time, each batch zero-padded
to a power-of-two row count as in the reference.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from kirag_tpu_torch.ops.mips import topk_mips


def _pad_rows(arrays: Dict[str, np.ndarray], target: int) -> Dict[str, np.ndarray]:
    cur = len(next(iter(arrays.values())))
    if cur == target:
        return arrays
    return {k: np.pad(v, ((0, target - cur),) + ((0, 0),) * (v.ndim - 1))
            for k, v in arrays.items()}


class DenseRetriever:
    def __init__(self, encoder, collator, indexer=None, corpus=None,
                 batch_size: int = 32, temperature: Union[float, str] = 1.0,
                 search_mode: str = "exact"):
        """``temperature`` divides :meth:`score`'s logits: a number, or
        "sqrt" for the square root of the embedding width."""
        if search_mode not in ("exact", "approx"):
            raise ValueError(f"search_mode must be exact|approx, got {search_mode!r}")
        self.encoder = encoder
        self.collator = collator
        self.indexer = indexer
        self.corpus = corpus
        self.batch_size = batch_size
        self.temperature = temperature
        self.search_mode = search_mode

    # -- embedding ------------------------------------------------------------

    def _embed_texts(self, texts: List[str], encode_fn, max_length: Optional[int]) -> np.ndarray:
        if not isinstance(texts, list) or not texts:
            raise ValueError("must provide a non-empty list of texts")
        out = []
        for start in range(0, len(texts), self.batch_size):
            batch = texts[start:start + self.batch_size]
            kwargs = {"max_length": max_length} if max_length else {}
            args = encode_fn(batch, **kwargs)
            n_real = len(batch)
            bucket = 1
            while bucket < n_real:
                bucket *= 2
            args = _pad_rows(args, min(bucket, self.batch_size))
            emb = self.encoder(args["input_ids"], args["attention_mask"])
            out.append(emb[:n_real].to(torch.float32).cpu().numpy())
        return np.concatenate(out, axis=0)

    def calculate_query_embeddings(self, queries: List[str],
                                   max_length: Optional[int] = None, **kwargs) -> np.ndarray:
        return self._embed_texts(queries, self.collator.encode_query, max_length)

    def calculate_document_embeddings(self, documents: List[str],
                                      max_length: Optional[int] = None, **kwargs) -> np.ndarray:
        return self._embed_texts(documents, self.collator.encode_doc, max_length)

    # -- scoring ---------------------------------------------------------------

    @staticmethod
    def compute_logits(query_embeddings: np.ndarray, doc_embeddings: np.ndarray) -> np.ndarray:
        """Similarities dispatched on the shapes: [d] x [d] -> scalar,
        [d] x [m, d] -> [m], [n, d] x [n, m, d] -> [n, m] (each query against
        its own documents), [n, d] x [m, d] -> [n, m]."""
        q, d = np.asarray(query_embeddings), np.asarray(doc_embeddings)
        if q.ndim == 1 and d.ndim == 1:
            return np.einsum("d,d->", q, d)
        if q.ndim == 1 and d.ndim == 2:
            return np.einsum("d,md->m", q, d)
        if q.ndim == 2 and d.ndim == 3:
            if len(q) != len(d):
                raise ValueError(f"{len(q)} queries for {len(d)} document sets")
            return np.einsum("nd,nmd->nm", q, d)
        if q.ndim == 2 and d.ndim == 2:
            return np.einsum("nd,md->nm", q, d)
        raise ValueError(f"Invalid embedding shapes: {q.shape} vs {d.shape}")

    def score(self, query_embeddings: np.ndarray, doc_embeddings: np.ndarray) -> np.ndarray:
        """:meth:`compute_logits` divided by the temperature ("sqrt": by the
        square root of the embedding width)."""
        logits = self.compute_logits(query_embeddings, doc_embeddings)
        if self.temperature == "sqrt":
            return logits / np.sqrt(np.asarray(query_embeddings).shape[-1])
        return logits / self.temperature

    def encode_score_rank(self, queries: List[str], documents: List[str], k: int,
                          query_maxlength: Optional[int] = None,
                          doc_maxlength: Optional[int] = None
                          ) -> Tuple[List[List[int]], List[List[float]]]:
        """Embed queries and documents, then the per-query top-k documents as
        (indices, scores)."""
        device = self.encoder.device
        q_emb = torch.from_numpy(self.calculate_query_embeddings(
            queries, max_length=query_maxlength)).to(device)
        d_emb = torch.from_numpy(self.calculate_document_embeddings(
            documents, max_length=doc_maxlength)).to(device)
        vals, idx = topk_mips(q_emb, d_emb, min(k, len(documents)),
                              chunk_size=max(8, len(documents)))
        return idx.cpu().tolist(), vals.cpu().tolist()

    # -- retrieval ---------------------------------------------------------------

    def get_documents(self, docid_list: Union[List[str], Dict[str, float]]) -> List[dict]:
        if isinstance(docid_list, list):
            return [deepcopy(self.corpus.get_document(docid)) for docid in docid_list]
        if isinstance(docid_list, dict):
            documents = []
            for docid, score in sorted(docid_list.items(), key=lambda x: x[1], reverse=True):
                doc = deepcopy(self.corpus.get_document(docid))
                doc["score"] = float(score)
                documents.append(doc)
            return documents
        raise ValueError(f"{type(docid_list)} is not a supported type for docid_list")

    def batch_retrieve(self, queries: List[str], topk: int, mode: Optional[str] = None,
                       **kwargs) -> List[List[dict]]:
        """``mode``: the index's search mode, "exact" or "approx" (None: the
        retriever's ``search_mode``)."""
        if self.indexer is None:
            raise ValueError("must provide an indexer")
        embeddings = self.calculate_query_embeddings(queries, **kwargs)
        return self._documents(self._search(embeddings, topk, mode))

    # the steps of batch_retrieve: encode (calculate_query_embeddings), then
    # these two; RetrievalEngine over a mesh runs the search on every rank and
    # the rest on the first rank only

    def _search(self, embeddings: np.ndarray, topk: int,
                mode: Optional[str] = None) -> List[Tuple[List[str], np.ndarray]]:
        return self.indexer.search_knn(embeddings, top_docs=topk,
                                       mode=mode or self.search_mode)

    def _documents(self, knn_results) -> List[List[dict]]:
        """Each query's ``(db_ids, scores)`` as ranked documents: the
        corpus's documents with their scores, or ``{"id", "score"}``."""
        retrieval_results = []
        for db_ids, scores in knn_results:
            one = []
            for docid, score in zip(db_ids, scores):
                if self.corpus is not None:
                    doc = deepcopy(self.corpus.get_document(docid))
                    doc["score"] = float(score)
                else:
                    doc = {"id": docid, "score": float(score)}
                one.append(doc)
            retrieval_results.append(one)
        return retrieval_results

    def __call__(self, queries: Union[str, List[str]], topk: int, **kwargs):
        if isinstance(queries, str):
            return self.batch_retrieve([queries], topk=topk, **kwargs)[0]
        return self.batch_retrieve(queries, topk=topk, **kwargs)
