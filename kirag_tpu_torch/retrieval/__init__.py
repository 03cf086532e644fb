from kirag_tpu_torch.retrieval.dense import DenseRetriever

__all__ = ["DenseRetriever"]
