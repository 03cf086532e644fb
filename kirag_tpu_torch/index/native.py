"""ctypes binding of the port's CPU flat index (``csrc/host/flat_index.cpp``;
port of :mod:`kirag_tpu.index.native`).

The host-side counterpart of :class:`kirag_tpu_torch.index.TorchIndexer` for
machines without an accelerator, in FAISS's flat-index role: exact inner
product or squared l2, ties to the lower row, with the same
``index_data``/``search_knn``/``serialize``/``deserialize_from`` surface and
the reference's on-disk files (``index.flat``, ``index_meta.pkl``). The
library is built with g++ at first use
(:func:`kirag_tpu_torch.kernels.build.build_host`), never at import.
"""

from __future__ import annotations

import ctypes
import logging
import os
import pickle
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

METRIC_CODES = {"inner_product": 0, "l2": 1}


def _load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            from kirag_tpu_torch.kernels.build import load_host_library

            lib = load_host_library("flat_index")
            f32p, i64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
            lib.flat_index_create.restype = ctypes.c_void_p
            lib.flat_index_create.argtypes = [ctypes.c_int64, ctypes.c_int]
            lib.flat_index_free.argtypes = [ctypes.c_void_p]
            lib.flat_index_ntotal.restype = ctypes.c_int64
            lib.flat_index_ntotal.argtypes = [ctypes.c_void_p]
            lib.flat_index_add.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
            lib.flat_index_search.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64,
                                              ctypes.c_int64, f32p, i64p]
            lib.flat_index_save.restype = ctypes.c_int
            lib.flat_index_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.flat_index_load.restype = ctypes.c_void_p
            lib.flat_index_load.argtypes = [ctypes.c_char_p]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the library builds and loads here (g++ and OpenMP present)."""
    try:
        _load_library()
        return True
    except Exception as e:  # no toolchain
        logger.warning(f"native flat index unavailable: {e}")
        return False


class CPUFlatIndex:
    """Exact flat index in host memory, searched by the C++ library."""

    def __init__(self, vector_sz: int, metric: str = "inner_product"):
        if metric not in METRIC_CODES:
            raise KeyError(f"metric must be one of {tuple(METRIC_CODES)}, got {metric}")
        self.vector_sz = vector_sz
        self.metric = metric
        self._lib = _load_library()
        self._handle = ctypes.c_void_p(self._lib.flat_index_create(vector_sz,
                                                                   METRIC_CODES[metric]))
        self.index_id_to_db_id: List[str] = []

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.flat_index_free(handle)
            self._handle = None

    def __len__(self) -> int:
        return int(self._lib.flat_index_ntotal(self._handle))

    @property
    def ntotal(self) -> int:
        return len(self)

    def index_data(self, ids: Sequence, embeddings: np.ndarray) -> None:
        embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.vector_sz:
            raise ValueError(f"expected [n, {self.vector_sz}] embeddings, "
                             f"got {embeddings.shape}")
        if len(ids) != len(embeddings):
            raise ValueError(f"{len(ids)} ids for {len(embeddings)} embeddings")
        self._lib.flat_index_add(self._handle,
                                 embeddings.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 len(embeddings))
        self.index_id_to_db_id.extend(str(i) for i in ids)

    def search_knn(self, query_vectors: np.ndarray, top_docs: int,
                   index_batch_size: int = 4096, verbose: bool = False
                   ) -> List[Tuple[List[str], np.ndarray]]:
        """Per-query ``([db_id, ...], scores)``, best first (l2: squared
        distances ascending). ``top_docs`` past the index returns the rows
        there are; ``index_batch_size`` and ``verbose`` are accepted for the
        reference's signature and change nothing, as there."""
        queries = np.ascontiguousarray(query_vectors, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        nq = len(queries)
        k = min(top_docs, max(len(self), 1))
        scores = np.empty((nq, k), dtype=np.float32)
        indices = np.empty((nq, k), dtype=np.int64)
        self._lib.flat_index_search(
            self._handle, queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq, k,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return [([self.index_id_to_db_id[i] if i >= 0 else "" for i in indices[row]],
                 scores[row]) for row in range(nq)]

    # -- persistence ----------------------------------------------------------

    def serialize(self, dir_path: str) -> None:
        os.makedirs(dir_path, exist_ok=True)
        rc = self._lib.flat_index_save(self._handle,
                                       os.path.join(dir_path, "index.flat").encode())
        if rc != 0:
            raise IOError(f"failed to save the flat index under {dir_path}")
        with open(os.path.join(dir_path, "index_meta.pkl"), "wb") as f:
            pickle.dump(self.index_id_to_db_id, f)

    def deserialize_from(self, dir_path: str) -> None:
        handle = self._lib.flat_index_load(os.path.join(dir_path, "index.flat").encode())
        if not handle:
            raise IOError(f"failed to load the flat index from {dir_path}")
        self._lib.flat_index_free(self._handle)
        self._handle = ctypes.c_void_p(handle)
        with open(os.path.join(dir_path, "index_meta.pkl"), "rb") as f:
            self.index_id_to_db_id = list(pickle.load(f))
        if len(self.index_id_to_db_id) != len(self):
            raise ValueError(f"id map holds {len(self.index_id_to_db_id)} ids for "
                             f"{len(self)} rows")
