from kirag_tpu_torch.data.collators import (
    COLLATOR_MAP,
    BGECollator,
    E5Collator,
    RetrieverCollator,
    bucket_length,
)
from kirag_tpu_torch.data.corpus import (
    CORPUS_MAP,
    Corpus,
    HotPotQA,
    JsonCorpus,
    MuSiQue,
    WikiMultiHopQA,
    Wikipedia,
    load_psg_data,
)

__all__ = [
    "COLLATOR_MAP",
    "BGECollator",
    "E5Collator",
    "RetrieverCollator",
    "bucket_length",
    "CORPUS_MAP",
    "Corpus",
    "HotPotQA",
    "JsonCorpus",
    "MuSiQue",
    "WikiMultiHopQA",
    "Wikipedia",
    "load_psg_data",
]
