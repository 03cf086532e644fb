"""kirag_tpu_torch: the retrieval serving path and the offline index build
of ``kirag_tpu`` in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (H100).

Module names mirror ``kirag_tpu``; the JAX package is the reference this
port is tested against. The package imports ``torch`` and never ``jax``.

- ``device``     : device policy, ``require_cuda()``, TF32 flags.
- ``ops``        : pooling, the plain top-k scan, exact search over the kernels.
- ``kernels``    : the CUDA kernels' build step, wrappers and plain versions
                   (sources in ``csrc/``): exact search (K1, K2) and the
                   encoder's flash attention (K3).
- ``models``     : the BERT encoder, the bi-encoder heads, checkpoint loading.
- ``data``       : passage corpora and tokenization collators.
- ``index``      : the device-resident exact index.
- ``retrieval``  : the DenseRetriever facade.
- ``serving``    : the micro-batching RetrievalEngine.
- ``cli``        : ``compute_corpus_embeddings`` and ``build_index``.
- ``utils``      : JSON IO and logging setup.
"""

__version__ = "0.1.0"
