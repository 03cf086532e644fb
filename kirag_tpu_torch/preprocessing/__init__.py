from kirag_tpu_torch.preprocessing.odqa import (
    build_corpus_from_contexts,
    convert_simple_qa_tsv,
    load_comparison_map,
)

__all__ = [
    "build_corpus_from_contexts",
    "convert_simple_qa_tsv",
    "load_comparison_map",
]
