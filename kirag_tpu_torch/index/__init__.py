from kirag_tpu_torch.index.indexer import TorchIndexer

__all__ = ["TorchIndexer", "CPUFlatIndex"]


def __getattr__(name):
    # lazy: the flat index builds a C++ library on first use
    if name == "CPUFlatIndex":
        from kirag_tpu_torch.index.native import CPUFlatIndex

        return CPUFlatIndex
    raise AttributeError(name)
