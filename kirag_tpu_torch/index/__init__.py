from kirag_tpu_torch.index.indexer import TorchIndexer

__all__ = ["TorchIndexer"]
