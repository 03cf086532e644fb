from kirag_tpu_torch.pipeline.kirag import KiRAG

__all__ = ["KiRAG"]
