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
from kirag_tpu_torch.data.datasets import (
    KGChainRetrieverDataset,
    KGChainRetrieverSeqSampleDataset,
    RetrieverDataset,
    convert_triples_to_sentences,
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
    "KGChainRetrieverDataset",
    "KGChainRetrieverSeqSampleDataset",
    "RetrieverDataset",
    "convert_triples_to_sentences",
]
