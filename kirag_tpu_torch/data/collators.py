"""Query/document tokenization with bucketed padding (port of the encoding
half of :mod:`kirag_tpu.data.collators`: E5 and BGE prefixes and bucket
padding; the training-batch ``__call__`` belongs to the aligner trainer,
which is not ported).

The batch's longest sequence is rounded up to the next bucket (powers of two
capped at ``maxlength``), so the encoder sees few distinct shapes. Pure host
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
    """Tokenize queries/documents into bucket-padded numpy batches."""

    def __init__(self, tokenizer, query_maxlength: int, doc_maxlength: int):
        self.tokenizer = tokenizer
        self.query_maxlength = query_maxlength
        self.doc_maxlength = doc_maxlength

    def encode(self, text_list: Union[str, List[str]], maxlength: int) -> Dict[str, np.ndarray]:
        if text_list is None or (isinstance(text_list, (tuple, list)) and len(text_list) == 0):
            raise ValueError("text_list is None or an empty tuple/list!")
        if isinstance(text_list, str):
            text_list = [text_list]
        # encoders need right padding: the bucket trim below cuts trailing columns
        self.tokenizer.padding_side = "right"
        out = self.tokenizer(list(text_list), max_length=maxlength, padding="max_length",
                             truncation=True, return_tensors="np")
        attention_mask = out["attention_mask"].astype(np.int32)
        blen = bucket_length(int(attention_mask.sum(-1).max()), maxlength)
        return {"input_ids": out["input_ids"].astype(np.int32)[:, :blen],
                "attention_mask": attention_mask[:, :blen]}

    def encode_query(self, query_list, max_length=None):
        return self.encode(query_list, max_length or self.query_maxlength)

    def encode_doc(self, doc_list, max_length=None):
        return self.encode(doc_list, max_length or self.doc_maxlength)


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
