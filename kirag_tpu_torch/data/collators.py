"""Query/document tokenization with bucketed padding, and the training
batches of the aligner (port of :mod:`kirag_tpu.data.collators`: E5 and BGE
prefixes, ``"bucket"`` or ``"max_length"`` padding, the (query, positive +
negatives) ``__call__``).

With ``"bucket"`` padding the batch's longest sequence is rounded up to the
next bucket (powers of two capped at ``maxlength``), so the encoder sees few
distinct shapes; ``"max_length"`` keeps every row at ``maxlength``. Pure host
code over a HuggingFace-style tokenizer callable.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(max_len: int, maxlength: int,
                  buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= max_len, capped at maxlength."""
    for b in buckets:
        if b >= max_len:
            return min(b, maxlength)
    return maxlength


class RetrieverCollator:
    """Tokenize queries/documents into padded numpy batches; called on a list
    of training examples, pack a (query, positive + negatives) batch."""

    def __init__(self, tokenizer, query_maxlength: int, doc_maxlength: int,
                 query_padding: str = "bucket", doc_padding: str = "bucket"):
        for padding in (query_padding, doc_padding):
            if padding not in ("max_length", "bucket"):
                raise ValueError(f"padding must be 'max_length' or 'bucket', got {padding!r}")
        self.tokenizer = tokenizer
        self.query_maxlength = query_maxlength
        self.doc_maxlength = doc_maxlength
        self.query_padding = query_padding
        self.doc_padding = doc_padding

    def encode(self, text_list: Union[str, List[str]], maxlength: int,
               padding: str = "bucket") -> Dict[str, np.ndarray]:
        if text_list is None or (isinstance(text_list, (tuple, list)) and len(text_list) == 0):
            raise ValueError("text_list is None or an empty tuple/list!")
        if isinstance(text_list, str):
            text_list = [text_list]
        # encoders need right padding: the bucket trim below cuts trailing columns
        self.tokenizer.padding_side = "right"
        out = self.tokenizer(list(text_list), max_length=maxlength, padding="max_length",
                             truncation=True, return_tensors="np")
        input_ids = out["input_ids"].astype(np.int32)
        attention_mask = out["attention_mask"].astype(np.int32)
        if padding == "bucket":
            blen = bucket_length(int(attention_mask.sum(-1).max()), maxlength)
            input_ids, attention_mask = input_ids[:, :blen], attention_mask[:, :blen]
        return {"input_ids": input_ids, "attention_mask": attention_mask}

    def encode_query(self, query_list, max_length=None):
        return self.encode(query_list, max_length or self.query_maxlength, self.query_padding)

    def encode_doc(self, doc_list, max_length=None):
        return self.encode(doc_list, max_length or self.doc_maxlength, self.doc_padding)

    def __call__(self, batch: List[Union[dict, List[dict]]]):
        """A training batch of ``{"index", "question", "positive_passage",
        "negative_passages", ...}`` examples (or lists of them, which are
        flattened) -> ``(query_args, doc_args, positive_doc_indices, index)``
        as numpy arrays; docs are laid out ``[pos_0, negs_0..., pos_1,
        negs_1, ...]``."""
        if batch and isinstance(batch[0], list):
            batch = [ex for sub in batch for ex in sub]
        doc_list: List[str] = []
        positive_doc_indices: List[int] = []
        for ex in batch:
            positive_doc_indices.append(len(doc_list))
            doc_list.append(ex["positive_passage"])
            doc_list.extend(ex["negative_passages"])
        return (self.encode_query([ex["question"] for ex in batch]),
                self.encode_doc(doc_list),
                np.asarray(positive_doc_indices, dtype=np.int32),
                np.asarray([ex["index"] for ex in batch], dtype=np.int32))


class E5Collator(RetrieverCollator):
    """E5 prefixes: "query: " / "passage: "."""

    def encode_query(self, query_list, max_length=None):
        if isinstance(query_list, str):
            query_list = [query_list]
        return super().encode_query(["query: " + q for q in query_list], max_length)

    def encode_doc(self, doc_list, max_length=None):
        if isinstance(doc_list, str):
            doc_list = [doc_list]
        return super().encode_doc(["passage: " + d for d in doc_list], max_length)


class BGECollator(RetrieverCollator):
    """BGE query instruction prefix."""

    QUERY_INSTRUCTION = "Represent this sentence for searching relevant passages:"

    def encode_query(self, query_list, max_length=None):
        if isinstance(query_list, str):
            query_list = [query_list]
        return super().encode_query([f"{self.QUERY_INSTRUCTION} {q}" for q in query_list],
                                    max_length)


COLLATOR_MAP = {
    "E5Retriever": E5Collator,
    "BGERetriever": BGECollator,
    "e5": E5Collator,
    "bge": BGECollator,
}
