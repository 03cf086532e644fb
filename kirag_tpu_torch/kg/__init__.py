from kirag_tpu_torch.kg.triples import (
    find_sentence_for_triple,
    parse_triples_text,
    sent_tokenize,
    triple_to_sentence,
)
from kirag_tpu_torch.kg.kg_generator import KGGenerator

__all__ = [
    "parse_triples_text",
    "find_sentence_for_triple",
    "sent_tokenize",
    "triple_to_sentence",
    "KGGenerator",
]
