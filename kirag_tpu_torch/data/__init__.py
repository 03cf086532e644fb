from kirag_tpu_torch.data.collators import E5Collator, RetrieverCollator, bucket_length

__all__ = ["E5Collator", "RetrieverCollator", "bucket_length"]
