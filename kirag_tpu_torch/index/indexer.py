"""Device-resident flat index (port of
:class:`kirag_tpu.index.indexer.TPUIndexer`).

The corpus matrix lives on ``device`` (default: the GPU; the CPU only when
the caller passes ``device="cpu"``) in ``device_dtype`` (float32 or
bfloat16), or compressed (``compression="int8"``: int8 codes and a scale a
row; ``"int4"``: packed 4-bit codes and a scale per 128-dim block; ``"pq"``:
4-bit product-quantization codes, ``pq_m / 2`` bytes a row, scored through
a [16, D] level table), quantized block by block where it lies; pre-padded
with zero rows to whole 128-row groups, and to the search chunk grid for the
kernel search. PQ codebooks are trained once, on the device, from an evenly
strided sample of at most ``pq_train_rows`` rows (:mod:`kirag_tpu_torch.ops.pq`),
and are kept across appends and written by ``serialize``; FAISS's
``IndexPQ(n_subquantizers, n_bits)`` request maps onto them.

``search_knn(mode="exact")``: on a CUDA device the exact stream-capture
search (:func:`kirag_tpu_torch.ops.exact.exact_topk_mips`) in flag mode,
re-dispatching the checked search when the capture's exactness flag is
False; on the CPU the plain scan (:func:`topk_mips`, or
:func:`topk_mips_int8`/:func:`topk_mips_int4`). ``mode="approx"``: the
group-sampled search (:func:`kirag_tpu_torch.ops.approx.approx_topk_mips`,
``approx_winners`` candidates per 128-row group) on any device, its kernel
on the card and its plain version on the CPU. A PQ index is always searched
by the exact search over its codes (the kernels on the card, their plain
versions on the CPU), ``mode="approx"`` included, as in the reference.

Metrics: ``inner_product`` (scores descending, faiss.IndexFlatIP) and
``l2`` (squared distances ascending, faiss.IndexFlatL2), served by the same
search over a corpus augmented with a ``-0.5 * alpha * ||c||^2`` column and
queries with a ``1 / alpha`` column (see :meth:`_l2_augment`).
``shuffle_rows`` permutes the rows once with a seeded permutation before
they are placed or written (the id map moves with them), which approximate
search needs on corpora whose similar rows sit together.

``max_device_rows`` streams a corpus of more rows than that through the
device at search time instead of placing it (a float32 DPR index, 86 GB, on
an 80 GB card): the rows are cut into blocks of ``max_device_rows`` rounded
down to a multiple of 8 (the last one zero-padded), each held in host memory
in its device format (int8/int4 quantized a block at a time) and, on a GPU,
pinned. A search copies block after block into one of two device buffers
on a side stream, the copy of block i + 1 overlapping the search of block
i, runs the exact search (in its checked mode) or the approximate search on
each, and merges the blocks' top-k by value, then global row id. PQ does
not stream (its codes are 32x smaller and stay on the device).

``mesh`` (a :class:`~kirag_tpu_torch.parallel.mesh.Mesh`) row-shards the
corpus over the ``mesh_axis`` ranks, as the reference shards it over its
mesh: the rows are padded to a multiple of ``128 x shards`` (of the chunk
grid times the shards for the kernel search of a corpus of at least one
chunk a shard), and each rank places only its own range of them (quantized,
augmented and shuffled as the whole corpus would be, so its codes and scales
are bitwise the unsharded index's rows; PQ codebooks are trained on the
mesh's first rank and broadcast). A search is a collective: every rank of
the mesh calls ``search_knn`` with the same queries, which are broadcast
from the first rank of the data group, searches its shard and merges the
shards' candidates (the ``sharded_*`` searches of :mod:`kirag_tpu_torch.ops`);
every rank gets the result. :class:`~kirag_tpu_torch.serving.RetrievalEngine`
serves such an index by that protocol: its leader, the mesh's first rank,
broadcasts each batch's embeddings over the whole mesh, and every rank's
engine then calls ``search_knn`` on them. Over a mesh the ``model`` axis
replicates the index. Streaming refuses a mesh, as in the reference.

The on-disk format (``serialize``/``deserialize_from``: raw f32 shards, the
metric, compression and ``pq_m`` in the config, ``pq_codebooks.npy``) is the
reference's, so an index written by ``TPUIndexer`` loads here and back. It
does not depend on a mesh: the host rows are the whole corpus on every rank,
and only the mesh's first rank writes.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from kirag_tpu_torch.device import require_cuda
from kirag_tpu_torch.kernels.exact import (
    LANES,
    MAX_INT4_DIM,
    pq_kernel_geometry_error,
    row_scales,
)
from kirag_tpu_torch.ops.approx import approx_topk_mips, sharded_approx_topk_mips
from kirag_tpu_torch.ops.exact import exact_topk_mips, sharded_exact_topk_mips
from kirag_tpu_torch.ops.mips import sharded_topk_mips, topk_mips
from kirag_tpu_torch.ops.pq import encode_pq, pq_level_table, resolve_subquantizers, train_pq
from kirag_tpu_torch.ops.quantized import (
    INT4_BLOCK,
    quantize_rows_int4_torch,
    quantize_rows_int8_torch,
    sharded_topk_mips_int4,
    sharded_topk_mips_int8,
    topk_mips_int4,
    topk_mips_int8,
)
from kirag_tpu_torch.parallel.mesh import broadcast

logger = logging.getLogger(__name__)

_HOST_BLOCK = 1 << 16  # rows per host->device copy
_SHUFFLE_BLOCK = 1 << 20  # rows per block of the shuffled host layout (the reference's)
_L2_WIDTH_UNIT = 16  # an l2 corpus's device width: the kernels' 16-byte row vectors
SUPPORTED_METRICS = ("inner_product", "l2")


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _check_compression(compression: str, vector_sz: int) -> None:
    if compression not in ("none", "int8", "int4", "pq"):
        raise KeyError(f"compression must be 'none', 'int8', 'int4' or 'pq', got {compression}")
    if compression == "int4" and vector_sz % 256 != 0:
        raise ValueError("int4 compression needs vector_sz % 256 == 0 (plane packing), "
                         f"got {vector_sz}")


class TorchIndexer:
    """Flat index over a device-resident embedding matrix.

    ``exact_impl``: "kernel" runs the exact kernel search (CUDA kernels on a
    GPU, their plain versions on the CPU), "plain" the chunked scan of
    :func:`topk_mips`, "auto" the kernel search on CUDA and the scan
    elsewhere (the reference's pallas/xla split). ``pallas_select`` is the
    kernel search's selection ("hier", "flat", "capdom" or "merge",
    :func:`~kirag_tpu_torch.ops.exact.exact_topk_mips`). ``approx_winners`` (1 to
    128) is the approximate search's candidates per 128-row group: 1 samples
    one winner a group, 2 removes the dominant same-group miss, 128 is exact.

    ``n_subquantizers`` with ``compression="none"`` is FAISS's
    ``IndexPQ(n_subquantizers, n_bits)`` request: it selects ``"pq"`` with
    ``pq_m`` 4-bit subquantizers, twice as many when ``n_bits`` > 4 (equal
    bytes a row). With ``compression="pq"`` it is ``pq_m`` itself (default
    ``vector_sz / 4``). PQ serves the inner product only, from device memory.

    ``mesh`` and ``mesh_axis`` shard the corpus's rows over that axis of the
    mesh (see the module docstring); ``device`` is then this rank's device.
    """

    def __init__(self, vector_sz: int, metric: str = "inner_product",
                 device=None, device_dtype: torch.dtype = torch.float32,
                 chunk_size: int = 262144, compression: str = "none",
                 n_subquantizers: int = 0, n_bits: int = 8, mesh=None,
                 mesh_axis: str = "data", max_device_rows: Optional[int] = None,
                 exact_impl: str = "auto", pallas_chunk_size: int = 16384,
                 pallas_select: str = "capdom",
                 shuffle_rows: bool = False, shuffle_seed: int = 0, approx_winners: int = 1):
        faiss_pq_request = n_subquantizers > 0 and compression == "none"
        if faiss_pq_request:
            compression = "pq"
            logger.info(f"PQ({n_subquantizers}x{n_bits}b) requested -> codebook product "
                        "quantization")
        if metric not in SUPPORTED_METRICS:
            raise KeyError(f"metric must be one of {SUPPORTED_METRICS}, got {metric}")
        _check_compression(compression, vector_sz)
        self.pq_m = 0
        if compression == "pq":
            if metric != "inner_product":
                raise ValueError("compression='pq' supports inner_product only (quantize the "
                                 "l2 norm column via int4/int8 compression instead)")
            if max_device_rows is not None:
                raise ValueError("compression='pq' keeps the corpus on the device; streaming "
                                 "mode does not compose with it")
            self.pq_m = resolve_subquantizers(vector_sz, n_subquantizers or max(2, vector_sz // 4),
                                              n_bits if faiss_pq_request else 4)
        if mesh is not None and max_device_rows is not None:
            raise ValueError("streaming mode is single-device: over a mesh, shard the corpus "
                             "across it instead")
        if pallas_select not in ("hier", "flat", "capdom", "merge"):
            raise KeyError(f"pallas_select must be hier|flat|capdom|merge, got {pallas_select}")
        if exact_impl not in ("auto", "kernel", "plain"):
            raise KeyError(f"exact_impl must be auto|kernel|plain, got {exact_impl}")
        if device_dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"device_dtype must be float32 or bfloat16, got {device_dtype}")
        if pallas_chunk_size < LANES or pallas_chunk_size % LANES != 0:
            raise ValueError("pallas_chunk_size must be a positive multiple of 128, "
                             f"got {pallas_chunk_size}")
        if not 1 <= approx_winners <= LANES:
            raise ValueError(f"approx_winners must be in [1, {LANES}], got {approx_winners}")
        self.vector_sz = vector_sz
        self.metric = metric
        self.device = require_cuda() if device is None else torch.device(device)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.device_dtype = device_dtype
        self.chunk_size = chunk_size
        self.compression = compression
        self.exact_impl = exact_impl
        self.pallas_chunk_size = pallas_chunk_size
        self.pallas_select = pallas_select
        self.shuffle_rows = shuffle_rows
        self.shuffle_seed = shuffle_seed
        self._shuffled = False
        self.approx_winners = approx_winners
        # pq: codebooks train once (the first to_device or serialize, or load
        # with the index) and persist across appends; codes re-encode
        self.pq_train_rows = 131072
        self.pq_iters = 25
        self._pq_codebooks: Optional[np.ndarray] = None
        # l2: the power-of-two factor of the norm column (int8 only, see
        # _fit_l2_alpha); exact in f32 and bf16, and so is its inverse
        self._l2_alpha = 1.0
        self._check_device_depth()
        self._host_chunks: List[np.ndarray] = []
        self.index_id_to_db_id: np.ndarray = np.empty((0,), dtype=object)
        self._device_corpus: Optional[torch.Tensor] = None
        # int8 [N], int4 [N, D/128], pq the level table [16, D]
        self._device_scales: Optional[torch.Tensor] = None
        self._device_rows: int = 0
        # searches whose capture flag was False and that ran the checked search
        self.redispatches = 0
        # streaming: rows beyond max_device_rows pass through the device in
        # blocks at search time (None: the whole corpus is placed)
        self.max_device_rows = max_device_rows
        self._stream_blocks: Optional[List[dict]] = None
        self._stream_buffers: Optional[List[dict]] = None
        # set stream_timing to record CUDA events around each block's copy
        # and search in stream_events: [(copy start, copy end, search start,
        # search end), ...] for the last streamed search
        self.stream_timing = False
        self.stream_events: List[tuple] = []

    # -- build ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.index_id_to_db_id)

    @property
    def ntotal(self) -> int:
        return len(self)

    def index_data(self, ids: Sequence, embeddings: np.ndarray) -> None:
        """Append rows; the device copy refreshes on the next search."""
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.vector_sz:
            raise ValueError(f"expected [n, {self.vector_sz}] embeddings, "
                             f"got {embeddings.shape}")
        if len(ids) != len(embeddings):
            raise ValueError(f"{len(ids)} ids for {len(embeddings)} embeddings")
        self._host_chunks.append(embeddings)
        new_ids = np.asarray([str(i) for i in ids], dtype=object)
        self.index_id_to_db_id = np.concatenate([self.index_id_to_db_id, new_ids])
        self._device_corpus = self._device_scales = None
        self._drop_stream_blocks()
        self._shuffled = False  # appended rows join the next shuffle
        logger.info(f"Total data indexed {len(self.index_id_to_db_id)}")

    def _host_rows(self, start: int, end: int) -> np.ndarray:
        """Rows [start, end) across the host chunk list, without concatenating
        the whole corpus (chunks may be mmap'd shard files)."""
        parts, ofs = [], 0
        for chunk in self._host_chunks:
            lo, hi = max(start - ofs, 0), min(end - ofs, len(chunk))
            if lo < hi:
                parts.append(np.asarray(chunk[lo:hi], dtype=np.float32))
            ofs += len(chunk)
            if ofs >= end:
                break
        if not parts:
            return np.zeros((0, self.vector_sz), dtype=np.float32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def _host_take(self, indices: np.ndarray) -> np.ndarray:
        """Rows at ``indices`` across the host chunk list (a bounded block
        of them at a time, so no second copy of the corpus is made)."""
        out = np.empty((len(indices), self.vector_sz), dtype=np.float32)
        ofs = 0
        for chunk in self._host_chunks:
            m = (indices >= ofs) & (indices < ofs + len(chunk))
            if m.any():
                out[m] = np.asarray(chunk[indices[m] - ofs], dtype=np.float32)
            ofs += len(chunk)
        return out

    def _maybe_shuffle(self) -> None:
        """Apply the ``shuffle_rows`` permutation
        (``np.random.default_rng(shuffle_seed).permutation``) once per corpus
        state, on the host, block by block; the id map moves with the rows,
        so the returned ids are unchanged and only the order among exactly
        equal scores follows the new layout."""
        if not self.shuffle_rows or self._shuffled or len(self) == 0:
            return
        n = len(self)
        perm = np.random.default_rng(self.shuffle_seed).permutation(n)
        self._host_chunks = [self._host_take(perm[start:start + _SHUFFLE_BLOCK])
                             for start in range(0, n, _SHUFFLE_BLOCK)]
        self.index_id_to_db_id = self.index_id_to_db_id[perm]
        self._shuffled = True

    def _l2_aug_width(self) -> int:
        """Depth of the augmented corpus for metric="l2": one norm column,
        or 256 for int4 (packing needs D % 256 == 0; the norm opens its own
        128-dim scale block, where it quantizes without loss)."""
        if self.metric != "l2":
            return self.vector_sz
        return self.vector_sz + (256 if self.compression == "int4" else 1)

    def _device_width(self) -> int:
        """Depth of the corpus on the device: the augmented width, padded
        with zero columns to the kernels' row vectors for l2 (fma(0, 0, s)
        is s, and zeros change no row's absmax, so no score moves)."""
        d = self._l2_aug_width()
        if self.metric == "l2" and self.compression != "int4":
            d = -(-d // _L2_WIDTH_UNIT) * _L2_WIDTH_UNIT
        return d

    def _check_device_depth(self) -> None:
        """The card's int4 kernels take depths up to MAX_INT4_DIM, its pq4
        kernels the geometries of :func:`pq_kernel_geometry_error`: raise here
        rather than at the first search."""
        if self.device.type != "cuda":
            return
        if self.compression == "int4" and self._l2_aug_width() > MAX_INT4_DIM:
            raise ValueError(f"an int4 index of depth {self._l2_aug_width()} (vector_sz "
                             f"{self.vector_sz}, metric {self.metric}) exceeds the CUDA "
                             f"kernels' {MAX_INT4_DIM}")
        if self.compression == "pq":
            why = pq_kernel_geometry_error(self.vector_sz, self.pq_m)
            if why is not None:
                raise ValueError(f"a pq index of {self.pq_m} subquantizers: {why}")

    def _l2_augment(self, rows: np.ndarray) -> np.ndarray:
        """Append the ``alpha * -0.5 * ||c||^2`` column (and int4's 255 zero
        columns): argmin ||q - c||^2 is argmax q.c - 0.5 ||c||^2, so the
        inner-product search serves l2 with a constant query column
        ``1 / alpha``. numpy, as the reference computes it."""
        nc = -0.5 * np.sum(rows.astype(np.float32) ** 2, axis=1, dtype=np.float32)[:, None]
        cols = [np.asarray(rows, dtype=np.float32), np.float32(self._l2_alpha) * nc]
        if self.compression == "int4":
            cols.append(np.zeros((len(rows), 255), dtype=np.float32))
        return np.concatenate(cols, axis=1)

    def _fit_l2_alpha(self) -> None:
        """int8 + l2: the power of two that brings the norm column to the
        typical row absmax, so that the row's one int8 scale keeps resolving
        the data columns (the reference's rule, in numpy, so alpha is
        bitwise its)."""
        if self.metric != "l2" or self.compression != "int8":
            self._l2_alpha = 1.0
            return
        sample = self._host_rows(0, min(len(self), 4096))
        m_el = float(np.median(np.abs(sample).max(axis=1)))
        m_nc = float(np.median(0.5 * np.sum(sample ** 2, axis=1)))
        if m_el <= 0 or m_nc <= 0:
            self._l2_alpha = 1.0
            return
        self._l2_alpha = float(2.0 ** round(np.log2(m_el / m_nc)))

    def _train_pq(self, n: int) -> None:
        """Train the PQ codebooks once, on the device, from an evenly strided
        sample of the rows (a head sample of a corpus in article order would
        be biased), seeded with ``shuffle_seed``."""
        if self._pq_codebooks is not None:
            return
        n_train = min(n, self.pq_train_rows)
        step = max(1, n // n_train)
        sample = self._host_take(np.arange(0, n, step)[:n_train])
        self._pq_codebooks = train_pq(torch.from_numpy(sample).to(self.device), self.pq_m,
                                      iters=self.pq_iters, seed=self.shuffle_seed).cpu().numpy()

    def _mesh_codebooks(self, n: int) -> None:
        """On a mesh: the codebooks of the mesh's first rank (trained there
        if need be) on every rank, by one broadcast."""
        if self.mesh.rank == 0:
            self._train_pq(n)
            cb = torch.from_numpy(self._pq_codebooks).to(self.device)
        else:
            cb = torch.zeros((self.pq_m, 16, self.vector_sz // self.pq_m), dtype=torch.float32,
                             device=self.device)
        self._pq_codebooks = broadcast(cb, self.mesh).cpu().numpy()

    def _shard_count(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(self.mesh_axis)

    def _use_kernels(self) -> bool:
        if self.exact_impl == "auto":
            return self.device.type == "cuda"
        return self.exact_impl == "kernel"

    def to_device(self) -> None:
        """Place the corpus on the device (shuffled first under
        ``shuffle_rows``), zero-padded: to whole 128-row groups (the
        approximate search's unit), and for the kernel search of a corpus
        of at least one chunk to the chunk grid (either search would
        otherwise pad a copy per call); on a mesh, to that unit times the
        shards, of which this rank places its own range. Pad rows are
        masked through ``valid_rows``. A compressed corpus is quantized on
        the device, one host block at a time; its pad rows hold zero codes
        and zero scales (PQ: zero codes, which decode to centroid 0, and the
        one level table; the codebooks are trained first if they are not
        there yet). An l2 corpus is augmented on the host
        (:meth:`_l2_augment`) block by block on the way."""
        self._maybe_shuffle()
        self._fit_l2_alpha()
        n = len(self)
        shards = self._shard_count()
        unit = LANES * shards
        if self.exact_impl != "plain" and n >= self.pallas_chunk_size * shards:
            unit = self.pallas_chunk_size * shards
        n_pad = max(-(-n // unit) * unit, unit)
        n_here = n_pad // shards
        first = 0 if self.mesh is None else self.mesh.index(self.mesh_axis) * n_here
        d = self._device_width()
        scales = None
        if self.compression == "int8":
            mat = torch.zeros((n_here, d), dtype=torch.int8, device=self.device)
            scales = torch.zeros((n_here,), dtype=torch.float32, device=self.device)
        elif self.compression == "int4":
            mat = torch.zeros((n_here, d // 2), dtype=torch.uint8, device=self.device)
            scales = torch.zeros((n_here, d // INT4_BLOCK), dtype=torch.float32,
                                 device=self.device)
        elif self.compression == "pq":
            if self.mesh is not None:
                self._mesh_codebooks(n)
            else:
                self._train_pq(n)
            codebooks = torch.from_numpy(self._pq_codebooks).to(self.device)
            mat = torch.zeros((n_here, self.pq_m // 2), dtype=torch.uint8, device=self.device)
            scales = torch.from_numpy(pq_level_table(self._pq_codebooks)).to(self.device)
        else:
            mat = torch.zeros((n_here, d), dtype=self.device_dtype, device=self.device)
        last = min(first + n_here, n)
        for start in range(first, last, _HOST_BLOCK):
            rows = self._host_rows(start, min(start + _HOST_BLOCK, last))
            if self.metric == "l2":
                rows = self._l2_augment(rows)
            if not rows.flags.writeable:  # mmap'd shard: torch wants writable memory
                rows = rows.copy()
            block = slice(start - first, start - first + len(rows))
            cols = slice(0, rows.shape[1])  # l2: the zero columns past it stay zero
            rows = torch.from_numpy(rows).to(self.device)
            if self.compression == "int8":
                mat[block, cols], scales[block] = quantize_rows_int8_torch(rows)
            elif self.compression == "int4":
                mat[block], scales[block] = quantize_rows_int4_torch(rows)
            elif self.compression == "pq":
                mat[block] = encode_pq(rows, codebooks)
            else:
                mat[block, cols] = rows.to(self.device_dtype)
        self._device_corpus = mat
        self._device_scales = scales
        self._device_rows = n

    # -- streaming (corpora larger than device memory) ---------------------------

    def _use_streaming(self) -> bool:
        return self.max_device_rows is not None and len(self) > self.max_device_rows

    def _rows_per_block(self) -> int:
        return max(8, (self.max_device_rows // 8) * 8)

    def _drop_stream_blocks(self) -> None:
        self._stream_blocks = self._stream_buffers = None

    def _stream_block(self, start: int, rows_per_block: int) -> dict:
        """One block in its device format, in host memory (pinned when the
        index's device is a GPU): ``{"corpus", "scales", "start", "valid"}``.
        Rows past ``valid`` are zero rows, quantized with the block as the
        reference quantizes them; int8/int4 are quantized on the device,
        ``_HOST_BLOCK`` rows at a time."""
        rows = self._host_rows(start, min(start + rows_per_block, len(self)))
        if self.metric == "l2":
            rows = self._l2_augment(rows)
        if not rows.flags.writeable:  # mmap'd shard: torch wants writable memory
            rows = rows.copy()
        valid, aug = rows.shape
        rows = torch.from_numpy(rows)
        d = self._device_width()
        if self.compression == "int8":
            shapes = ((rows_per_block, d), torch.int8), ((rows_per_block,), torch.float32)
        elif self.compression == "int4":
            shapes = (((rows_per_block, d // 2), torch.uint8),
                      ((rows_per_block, d // INT4_BLOCK), torch.float32))
        else:
            shapes = ((rows_per_block, d), self.device_dtype), None
        pin = self.device.type == "cuda"
        corpus, scales = (None if shape is None else
                          torch.zeros(shape[0], dtype=shape[1], pin_memory=pin)
                          for shape in shapes)
        if pin and not (corpus.is_pinned() and (scales is None or scales.is_pinned())):
            raise RuntimeError("a streamed block's host memory could not be pinned")
        cols = slice(0, aug)  # l2: the zero columns past it stay zero
        if self.compression == "none":
            corpus[:valid, cols] = rows
            return {"corpus": corpus, "scales": None, "start": start, "valid": valid}
        for lo in range(0, rows_per_block, _HOST_BLOCK):
            part = slice(lo, min(lo + _HOST_BLOCK, rows_per_block))
            x = torch.zeros((part.stop - lo, aug), dtype=torch.float32, device=self.device)
            x[:max(min(valid - lo, len(x)), 0)] = rows[part].to(self.device)
            if self.compression == "int8":
                q, s = quantize_rows_int8_torch(x)
                corpus[part, cols], scales[part] = q.cpu(), s.cpu()
            else:
                q, s = quantize_rows_int4_torch(x)
                corpus[part], scales[part] = q.cpu(), s.cpu()
        return {"corpus": corpus, "scales": scales, "start": start, "valid": valid}

    def _prepare_stream_blocks(self) -> None:
        """Cut the corpus (shuffled first under ``shuffle_rows``, l2 alpha
        fitted) into blocks of ``max_device_rows`` rounded down to a multiple
        of 8, once; every search reuses them."""
        if self._stream_blocks is not None:
            return
        self._maybe_shuffle()
        self._fit_l2_alpha()
        rows_per_block = self._rows_per_block()
        self._stream_blocks = [self._stream_block(start, rows_per_block)
                               for start in range(0, len(self), rows_per_block)]

    def _buffer_rows(self, rows_per_block: int) -> int:
        """Rows of a device buffer: a block padded to whole 128-row groups,
        and for the kernel search of a block of at least one chunk to the
        chunk grid, so that no search pads a copy."""
        unit = LANES
        if self._use_kernels() and rows_per_block >= self.pallas_chunk_size:
            unit = self.pallas_chunk_size
        return -(-rows_per_block // unit) * unit

    def _device_blocks(self):
        """Yield ``(block, corpus, scales)`` for every block, in order, its
        rows in device memory. On a GPU two buffers take turns: the copy of
        block i + 1 is enqueued on a side stream before block i is handed out,
        the search waits for its own block's copy, and a buffer is written
        again only after the search that read it. Nothing falls back: a
        failed copy raises."""
        blocks = self._stream_blocks
        if self.device.type != "cuda":
            for blk in blocks:
                yield blk, blk["corpus"], blk["scales"]
            return
        if self._stream_buffers is None:
            n = self._buffer_rows(len(blocks[0]["corpus"]))
            self._stream_buffers = [
                {key: None if blocks[0][key] is None else
                 torch.zeros((n, *blocks[0][key].shape[1:]), dtype=blocks[0][key].dtype,
                             device=self.device) for key in ("corpus", "scales")}
                for _ in range(2)]
        compute = torch.cuda.current_stream(self.device)
        copy = torch.cuda.Stream(self.device)
        copy.wait_stream(compute)  # the queries and any earlier use of the buffers
        timing = self.stream_timing
        copied = [torch.cuda.Event(enable_timing=timing) for _ in blocks]
        freed = [torch.cuda.Event() for _ in blocks]
        marks = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] if timing else None
                 for _ in blocks]

        def enqueue_copy(i: int) -> None:
            buf, blk = self._stream_buffers[i % 2], blocks[i]
            with torch.cuda.stream(copy):
                if i >= 2:
                    copy.wait_event(freed[i - 2])
                if timing:
                    marks[i][0].record(copy)
                for key in ("corpus", "scales"):
                    if blk[key] is not None:
                        buf[key][:len(blk[key])].copy_(blk[key], non_blocking=True)
                copied[i].record(copy)

        enqueue_copy(0)
        for i, blk in enumerate(blocks):
            if i + 1 < len(blocks):
                enqueue_copy(i + 1)
            compute.wait_event(copied[i])
            if timing:
                marks[i][1].record(compute)
            buf = self._stream_buffers[i % 2]
            yield blk, buf["corpus"], buf["scales"]
            if timing:
                marks[i][2].record(compute)
            freed[i].record(compute)
        if timing:
            self.stream_events = [(m[0], c, m[1], m[2]) for c, m in zip(copied, marks)]

    def _block_search(self, queries: torch.Tensor, corpus: torch.Tensor,
                      scales: Optional[torch.Tensor], valid: int, k: int, mode: str):
        """One block's top-k, its row ids local to the block."""
        rows_per_block = self._rows_per_block()
        if mode == "approx":
            n = -(-rows_per_block // LANES) * LANES  # whole groups, not the chunk padding
            return approx_topk_mips(queries, corpus[:n], k, valid_rows=valid,
                                    scales=None if scales is None else scales[:n],
                                    winners_per_group=self.approx_winners)
        if self._use_kernels():
            # the checked search (on_miss="fallback"), as the reference streams
            return exact_topk_mips(queries, corpus, k, chunk_size=self.pallas_chunk_size,
                                   valid_rows=valid, select=self.pallas_select, scales=scales)
        corpus = corpus[:rows_per_block]
        kw = dict(chunk_size=min(self.chunk_size, rows_per_block), valid_rows=valid)
        if self.compression == "int8":
            return topk_mips_int8(queries, corpus, scales[:rows_per_block], k, **kw)
        if self.compression == "int4":
            return topk_mips_int4(queries, corpus, scales[:rows_per_block], k, **kw)
        return topk_mips(queries, corpus, k, **kw)

    def _streaming_search(self, queries: torch.Tensor, k: int,
                          mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search block after block and merge: by value descending, then
        global row id ascending (the reference's ``np.lexsort((idx, -vals))``),
        on the device with stable sorts."""
        self._prepare_stream_blocks()
        k_eff = min(k, len(self))
        vals, idx = [], []
        for blk, corpus, scales in self._device_blocks():
            v, i = self._block_search(queries, corpus, scales, blk["valid"], k_eff, mode)
            vals.append(v)
            idx.append(i + blk["start"])
        vals, idx = torch.cat(vals, dim=1), torch.cat(idx, dim=1)
        by_row = torch.argsort(idx, dim=1, stable=True)
        vals, idx = vals.gather(1, by_row), idx.gather(1, by_row)
        by_val = torch.argsort(-vals, dim=1, stable=True)[:, :k_eff]
        return vals.gather(1, by_val), idx.gather(1, by_val)

    # -- search ----------------------------------------------------------------

    def _search_queries(self, queries: torch.Tensor) -> torch.Tensor:
        """The queries the corpus is searched with: for l2 the constant
        ``1 / alpha`` column, then zeros up to the device width."""
        if self.metric != "l2":
            return queries
        q = torch.zeros((len(queries), self._device_width()), dtype=queries.dtype,
                        device=queries.device)
        q[:, :self.vector_sz] = queries
        q[:, self.vector_sz] = 1.0 / self._l2_alpha
        return q

    def _group_view(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The device corpus and its scales cut to the 128-row groups that
        hold indexed rows: views, no copy. The approximate search reads
        these, not the padding of the chunk grid, which would give only
        masked candidates. PQ's level table belongs to every row."""
        n = max(-(-self._device_rows // LANES), 1) * LANES
        return (self._device_corpus[:n],
                row_scales(self._device_scales, slice(0, n), self._kernel_quant))

    @property
    def _kernel_quant(self) -> str:
        """The kernels' name of this index's corpus format."""
        return "pq4" if self.compression == "pq" else self.compression

    def _kernel_search(self, queries: torch.Tensor, k: int, **kw):
        """The exact kernel search (``impl="auto"``, ``select=pallas_select``)
        in flag mode; a False flag re-dispatches the checked search, which
        re-scores on a miss."""
        search = dict(chunk_size=self.pallas_chunk_size, valid_rows=self._device_rows,
                      select=self.pallas_select, scales=self._device_scales, **kw)
        vals, idx, ok = exact_topk_mips(queries, self._device_corpus, k, on_miss="flag",
                                        **search)
        if bool(ok):
            return vals, idx
        self.redispatches += 1
        logger.info("stream capture missed a selected group; re-dispatching "
                    "the checked exact search")
        return exact_topk_mips(queries, self._device_corpus, k, **search)

    def _sharded_mips(self, queries: torch.Tensor, k: int,
                      mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_run_mips` over a mesh: every rank searches its shard and
        the shards' candidates merge (the reference's sharded dispatch). The
        exact kernel search takes each shard's capture flag and re-runs that
        shard's checked search on a miss, with no collective between."""
        corpus, scales = self._device_corpus, self._device_scales
        mesh, axis, valid = self.mesh, self.mesh_axis, self._device_rows
        if self.compression == "pq" or (mode == "exact" and self._use_kernels()):
            if self.compression == "pq" and mode == "approx":
                logger.info("mode='approx' on a pq index: serving the exact search over "
                            "the codes")
            quant = self._kernel_quant if self.compression == "pq" else None
            vals, idx, ok = sharded_exact_topk_mips(
                queries, corpus, k, mesh, axis, chunk_size=self.pallas_chunk_size,
                valid_rows=valid, select=self.pallas_select, scales=scales, quant=quant,
                on_miss="flag")
            if not bool(ok):
                self.redispatches += 1
            return vals, idx
        if mode == "approx":
            return sharded_approx_topk_mips(queries, corpus, k, mesh, axis, valid_rows=valid,
                                            scales=scales,
                                            winners_per_group=self.approx_winners)
        kw = dict(chunk_size=self.chunk_size, valid_rows=valid)
        if self.compression == "int8":
            return sharded_topk_mips_int8(queries, corpus, scales, k, mesh, axis, **kw)
        if self.compression == "int4":
            return sharded_topk_mips_int4(queries, corpus, scales, k, mesh, axis, **kw)
        return sharded_topk_mips(queries, corpus, k, mesh, axis, **kw)

    def _run_mips(self, queries: torch.Tensor, k: int,
                  mode: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
        if self.mesh is not None:
            return self._sharded_mips(queries, k, mode)
        if self.compression == "pq":
            # the codes are scored by K4's pq4 format only, as in the
            # reference, which serves mode="approx" with this exact search
            if mode == "approx":
                logger.info("mode='approx' on a pq index: serving the exact search over "
                            "the codes")
            return self._kernel_search(queries, k, quant=self._kernel_quant)
        if mode == "approx":
            corpus, scales = self._group_view()
            return approx_topk_mips(queries, corpus, k, valid_rows=self._device_rows,
                                    scales=scales, winners_per_group=self.approx_winners)
        corpus, scales = self._device_corpus, self._device_scales
        if not self._use_kernels():
            kw = dict(chunk_size=min(self.chunk_size, len(corpus)), valid_rows=self._device_rows)
            if self.compression == "int8":
                return topk_mips_int8(queries, corpus, scales, k, **kw)
            if self.compression == "int4":
                return topk_mips_int4(queries, corpus, scales, k, **kw)
            return topk_mips(queries, corpus, k, **kw)
        return self._kernel_search(queries, k)

    def search_knn(self, query_vectors: np.ndarray, top_docs: int,
                   index_batch_size: int = 1024, verbose: bool = False,
                   mode: str = "exact") -> List[Tuple[List[str], np.ndarray]]:
        """Per-query ``([db_id, ...], scores)``, best first: inner products
        descending, or for l2 squared distances ascending. ``mode``: "exact"
        or "approx" (the group-sampled search). Query batches are
        zero-padded to power-of-two row counts, as in the reference.
        ``verbose`` is accepted for the reference's signature and changes
        nothing, as there. Over a mesh this is a collective: every rank
        calls it with the same queries (each batch is broadcast from the
        first rank of the data group) and gets the same results."""
        if mode not in ("exact", "approx"):
            raise ValueError(f"mode must be exact|approx, got {mode!r}")
        if len(self) == 0:
            raise RuntimeError("search_knn on an empty index; call index_data first")
        streaming = self._use_streaming()
        if streaming:  # never the whole corpus on the device
            self._prepare_stream_blocks()  # fits the l2 alpha before the queries
            search = self._streaming_search
        else:
            if self._device_corpus is None:
                self.to_device()
            search = self._run_mips
        query_vectors = np.asarray(query_vectors, dtype=np.float32)
        if query_vectors.ndim == 1:
            query_vectors = query_vectors[None]
        n_q = len(query_vectors)
        k = min(top_docs, len(self))
        results: List[Tuple[List[str], np.ndarray]] = []
        for start in range(0, n_q, index_batch_size):
            q = query_vectors[start:start + index_batch_size]
            q_pad = _next_pow2(len(q))
            if q_pad != len(q):
                q = np.pad(q, ((0, q_pad - len(q)), (0, 0)))
            qt = torch.from_numpy(np.ascontiguousarray(q)).to(device=self.device,
                                                              dtype=self.device_dtype)
            if self.mesh is not None:  # one batch for every shard
                qt = broadcast(qt, self.mesh, self.mesh_axis)
            vals, idx = search(self._search_queries(qt), k, mode)
            if self.metric == "l2":  # ||q||^2 - 2 (q.c - 0.5 ||c||^2)
                vals = (qt.to(torch.float32) ** 2).sum(dim=1, keepdim=True) - 2.0 * vals
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            for row in range(min(index_batch_size, n_q - start)):
                db_ids = [str(self.index_id_to_db_id[i]) for i in idx[row]]
                results.append((db_ids, vals[row]))
        return results

    # -- persistence -----------------------------------------------------------

    def serialize(self, dir_path: str, rows_per_file: int = 1_000_000) -> None:
        """Write ``index_{start}_{end}.npy`` shard files of the raw f32 rows
        (in the shuffled order under ``shuffle_rows``), the id map and the
        config, in the reference's layout; for PQ also the codebooks
        (``pq_codebooks.npy``, trained first if need be), so that a reload
        gives the same codes without training again. Over a mesh only its
        first rank writes; the others return at once."""
        self._maybe_shuffle()
        if self.mesh is not None and self.mesh.rank != 0:
            return
        os.makedirs(dir_path, exist_ok=True)
        n = len(self)
        files = []
        for start in range(0, max(n, 1), rows_per_file):
            end = min(start + rows_per_file, n)
            name = f"index_{start:010d}_{end:010d}.npy"
            np.save(os.path.join(dir_path, name), self._host_rows(start, end))
            files.append(name)
        with open(os.path.join(dir_path, "index_meta.pkl"), "wb") as f:
            pickle.dump(list(self.index_id_to_db_id), f)
        if self.compression == "pq":
            self._train_pq(n)
            np.save(os.path.join(dir_path, "pq_codebooks.npy"), self._pq_codebooks)
        with open(os.path.join(dir_path, "index_config.json"), "w") as f:
            json.dump({"vector_sz": self.vector_sz, "metric": self.metric,
                       "compression": self.compression, "nrows": n, "pq_m": self.pq_m,
                       "files": files}, f)

    def _load_codebooks(self, dir_path: str) -> Optional[np.ndarray]:
        """``pq_codebooks.npy`` of a PQ index ([pq_m, 16, D / pq_m] f32), or
        None when the index has none (they are trained at the first use)."""
        path = os.path.join(dir_path, "pq_codebooks.npy")
        if not os.path.exists(path):
            return None
        codebooks = np.load(path)
        want = (self.pq_m, 16, self.vector_sz // max(self.pq_m, 1))
        if codebooks.shape != want:
            raise ValueError(f"pq_codebooks.npy holds {codebooks.shape}, the config {want}")
        return codebooks.astype(np.float32)

    def deserialize_from(self, dir_path: str, mmap: bool = True) -> None:
        """Load an index written by :meth:`serialize` or by ``TPUIndexer``."""
        config_file = os.path.join(dir_path, "index_config.json")
        files = None
        if os.path.exists(config_file):
            with open(config_file) as f:
                cfg = json.load(f)
            if cfg["vector_sz"] != self.vector_sz:
                raise ValueError(f"index built with dim {cfg['vector_sz']}, "
                                 f"indexer expects {self.vector_sz}")
            metric = cfg.get("metric", self.metric)
            if metric not in SUPPORTED_METRICS:
                raise KeyError(f"metric must be one of {SUPPORTED_METRICS}, got {metric}")
            compression = cfg.get("compression", self.compression)
            _check_compression(compression, self.vector_sz)
            self.metric, self.compression = metric, compression
            if compression == "pq":
                self.pq_m = cfg.get("pq_m", self.pq_m)
                self._pq_codebooks = self._load_codebooks(dir_path)
            self._check_device_depth()
            files = cfg.get("files")
        mode = "r" if mmap else None
        names = files or ["index.npy"]  # legacy monolithic layout
        self._host_chunks = [np.load(os.path.join(dir_path, name), mmap_mode=mode)
                             for name in names]
        # the reference's own id map, written by serialize
        with open(os.path.join(dir_path, "index_meta.pkl"), "rb") as f:
            self.index_id_to_db_id = np.asarray(pickle.load(f), dtype=object)
        n_rows = sum(len(c) for c in self._host_chunks)
        if len(self.index_id_to_db_id) != n_rows:
            raise ValueError(f"id map holds {len(self.index_id_to_db_id)} ids for "
                             f"{n_rows} rows")
        self._device_corpus = self._device_scales = None
        self._drop_stream_blocks()
