from kirag_tpu_torch.pipeline.kirag import KiRAG
from kirag_tpu_torch.pipeline.selector import TripleSelector

__all__ = ["KiRAG", "TripleSelector"]
