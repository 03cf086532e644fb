"""ctypes binding of the port's DPR-TSV parser (``csrc/host/tsv_corpus.cpp``;
port of :mod:`kirag_tpu.data.native_tsv`).

At 21M rows (psgs_w100.tsv, the DPR corpus) the Python line loop of
:func:`kirag_tpu_torch.data.corpus.load_psg_data` spends minutes building
about 10 GB of per-row dict and str objects. The parser returns three packed
byte blobs and their int64 offsets; :class:`TsvPassages` serves the same
``{"id", "title", "text"}`` dicts lazily, so Python objects exist only for
the rows that are read. The library is built with g++ at the first call
(:func:`kirag_tpu_torch.kernels.build.build_host`), never at import.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            from kirag_tpu_torch.kernels.build import load_host_library

            lib = load_host_library("tsv_corpus")
            lib.tsv_corpus_load.restype = ctypes.c_void_p
            lib.tsv_corpus_load.argtypes = [ctypes.c_char_p]
            lib.tsv_corpus_rows.restype = ctypes.c_int64
            lib.tsv_corpus_rows.argtypes = [ctypes.c_void_p]
            lib.tsv_corpus_offsets.argtypes = [ctypes.c_void_p] + [
                ctypes.POINTER(ctypes.c_int64)] * 3
            lib.tsv_corpus_blob_size.restype = ctypes.c_int64
            lib.tsv_corpus_blob_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.tsv_corpus_blob.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
            lib.tsv_corpus_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


class TsvPassages:
    """List-like lazy view of the parsed passages: ``passages[i]`` makes one
    ``{"id", "title", "text"}`` dict from the packed blobs; length, slices,
    negative indices and iteration follow the Python loader's list (header
    skipped, rows of fewer than three fields dropped)."""

    def __init__(self, blobs, offsets):
        self._blobs = blobs      # (ids, texts, titles) bytes
        self._offsets = offsets  # (ids, texts, titles) int64 [n + 1]
        self._n = len(offsets[0]) - 1

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self[i] for i in range(*index.indices(self._n))]
        if index < 0:
            index += self._n
        if not 0 <= index < self._n:
            raise IndexError(index)
        ids, texts, titles = self._blobs
        io, to, tto = self._offsets
        return {"id": ids[io[index]:io[index + 1]].decode("utf-8"),
                "title": titles[tto[index]:tto[index + 1]].decode("utf-8"),
                "text": texts[to[index]:to[index + 1]].decode("utf-8")}

    def __iter__(self) -> Iterator[dict]:
        for i in range(self._n):
            yield self[i]


def load_psg_data_native(path: str) -> TsvPassages:
    """Parse a DPR TSV with the C++ parser; the rows of the Python
    :func:`~kirag_tpu_torch.data.corpus.load_psg_data`."""
    lib = _load_library()
    handle = lib.tsv_corpus_load(os.fsencode(path))
    if not handle:
        raise OSError(f"the tsv parser could not read {path}")
    try:
        n = lib.tsv_corpus_rows(handle)
        offsets = [np.empty(n + 1, dtype=np.int64) for _ in range(3)]
        lib.tsv_corpus_offsets(handle, *(o.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
                                         for o in offsets))
        blobs = []
        for field in range(3):  # ids, texts, titles
            size = lib.tsv_corpus_blob_size(handle, field)
            buf = ctypes.create_string_buffer(max(size, 1))
            lib.tsv_corpus_blob(handle, field, buf)
            blobs.append(buf.raw[:size])
        return TsvPassages(tuple(blobs), tuple(offsets))
    finally:
        lib.tsv_corpus_free(handle)
