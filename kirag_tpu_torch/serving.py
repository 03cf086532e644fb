"""Serving: a pre-warmed, thread-safe retrieval engine with micro-batching
(port of :mod:`kirag_tpu.serving`, which is host-only code; the port carries
its own copy so that it imports nothing of the JAX package).

:class:`RetrievalEngine` owns a retriever, warms its search for the top-k
buckets at startup, and serves ``search()`` from any thread through one
worker that coalesces concurrent requests into one encoder batch and one
corpus sweep.

Over an index sharded across a mesh of more than one rank the engine runs
SPMD, as the reference's one JAX controller drives every chip: the mesh's
first rank leads and serves ``search()``; every other rank follows. For each
batch the leader encodes the texts, broadcasts a fixed-size header (command,
rows, k, mode) and the float32 embeddings over the whole mesh, and every
rank then calls ``indexer.search_knn`` on them, which is the sharded
search's collective; the leader alone maps the ids to documents.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from kirag_tpu_torch.parallel.mesh import broadcast

logger = logging.getLogger(__name__)

# the header's commands and modes (a broadcast int64 tensor of _HEADER entries)
_STOP, _SEARCH, _WARMUP, _ABORT = 0, 1, 2, 3
_MODES = ("exact", "approx")
_HEADER = 4  # command, rows, k, mode


@dataclass
class _Request:
    texts: List[str]
    topk: int
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[List] = None


class RetrievalEngine:
    def __init__(self, retriever, max_batch: int = 32, max_wait_ms: float = 2.0,
                 warmup: bool = True, topk_buckets: Tuple[int, ...] = (10, 100),
                 mode: Optional[str] = None):
        """
        Args:
          retriever: a DenseRetriever with an indexer (and optionally a corpus).
          max_batch: micro-batch cap (queries coalesced per corpus sweep).
          max_wait_ms: how long the batcher waits to fill a batch.
          warmup: run one search per top-k bucket at startup.
          mode: search mode passed to the retriever, "exact" or "approx"
            (None: the retriever's own ``search_mode``).

        Over a mesh of more than one rank (the indexer's ``mesh``), every
        rank constructs the engine with the same arguments, and ``leader``
        says which role it took. The mesh's first rank leads: it warms up,
        then serves ``search()`` from any thread. On every other rank the
        constructor blocks: it takes part in the warm-up, then in the search
        of each of the leader's batches, and returns once the leader's
        :meth:`close` has stopped the engine (``stats`` then counts the
        batches it searched); a follower's ``search()`` raises RuntimeError.
        Every collective of the leader's engine runs on one thread (the
        warm-up, then the worker), so no other collective may run on the
        mesh's groups while an engine runs. A request that fails before its
        batch is broadcast (encoding, a bad request) fails that batch's
        requests only; a warm-up that fails so sends the followers an abort,
        and their constructors raise. A failure in the sharded search, on
        any rank, is raised: a follower's constructor raises it, and the
        leader's engine hands it to the batch's waiters and serves no more
        batches (later requests raise RuntimeError).
        """
        self.retriever = retriever
        self.mode = mode
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.topk_buckets = tuple(sorted(topk_buckets))
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self.stats: Dict[str, float] = {"requests": 0, "batches": 0, "queries": 0}
        mesh = getattr(getattr(retriever, "indexer", None), "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.devices.size > 1 else None
        self.leader = self._mesh is None or self._mesh.rank == 0
        self._closed = False
        self._failed: Optional[Exception] = None  # a sharded search raised
        if not self.leader:
            self._closed = True
            self._follow()
            return
        if warmup:
            try:
                self._warmup()
            except Exception:
                if self._mesh is not None and self._failed is None:
                    self._send_header(_ABORT)  # the followers raise too
                raise
        self._worker.start()

    def _warmup(self) -> None:
        t0 = time.time()
        dummy = ["warmup query"] * 2
        for k in self.topk_buckets:
            self._retrieve(dummy, k, _WARMUP)
        logger.info(f"retrieval engine warmed in {time.time() - t0:.1f}s "
                    f"(topk buckets {self.topk_buckets})")

    def _bucket_topk(self, k: int) -> int:
        for b in self.topk_buckets:
            if b >= k:
                return b
        return self.topk_buckets[-1]

    # -- public API -------------------------------------------------------------

    def search(self, texts: List[str], topk: int = 10, timeout: float = 60.0) -> List:
        """Thread-safe retrieval; blocks until this request's results arrive."""
        if not self.leader:
            raise RuntimeError(f"rank {self._mesh.rank} follows the engine's leader, rank 0 "
                               "of the mesh: requests go to the leader's search()")
        if topk > self.topk_buckets[-1]:
            raise ValueError(f"topk={topk} exceeds the largest warmup bucket "
                             f"{self.topk_buckets[-1]}; construct the engine with a "
                             "bigger bucket")
        req = _Request(texts=list(texts), topk=topk)
        self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("retrieval request timed out")
        if isinstance(req.result, Exception):
            raise req.result
        return req.result

    def close(self) -> None:
        """Stop the worker; over a mesh, the leader's worker then sends the
        followers the stop (once: a second call does nothing)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # over a mesh the stop must reach the followers: wait for the batch
        # in flight (its collectives end or time out)
        self._worker.join(timeout=None if self._mesh is not None else 5)

    # -- the mesh protocol --------------------------------------------------------

    def _send_header(self, command: int, rows: int = 0, k: int = 0, mode: int = 0) -> None:
        header = torch.tensor([command, rows, k, mode], dtype=torch.int64)
        broadcast(header.to(self.retriever.indexer.device), self._mesh)

    def _retrieve(self, texts: List[str], k: int, command: int = _SEARCH) -> List[List[dict]]:
        """The retriever's batch_retrieve; over a mesh, encode here, then
        broadcast the batch and search it on every rank."""
        if self._mesh is None:
            return self.retriever.batch_retrieve(texts, topk=k, mode=self.mode)
        ret = self.retriever
        mode = self.mode or ret.search_mode
        if mode not in _MODES:
            raise ValueError(f"mode must be exact|approx, got {mode!r}")
        emb = ret.calculate_query_embeddings(texts)
        if emb.shape[1] != ret.indexer.vector_sz:
            raise ValueError(f"{emb.shape[1]}-wide embeddings for an index of "
                             f"{ret.indexer.vector_sz}")
        # from the header on every rank takes part: a failure is not survived
        try:
            self._send_header(command, len(emb), k, _MODES.index(mode))
            broadcast(torch.from_numpy(emb).to(ret.indexer.device), self._mesh)
            knn = ret._search(emb, k, mode)
        except Exception as e:
            self._failed = e
            raise
        return ret._documents(knn)

    def _follow(self) -> None:
        """A follower's loop: each of the leader's batches searched here
        (its warm-up included), until the leader's stop."""
        ret = self.retriever
        device = ret.indexer.device
        while True:
            header = broadcast(torch.zeros(_HEADER, dtype=torch.int64, device=device),
                               self._mesh)
            command, rows, k, mode = (int(x) for x in header.cpu())
            if command == _STOP:
                return
            if command == _ABORT:
                raise RuntimeError("the engine's leader, rank 0 of the mesh, failed to "
                                   "start")
            emb = broadcast(torch.zeros((rows, ret.indexer.vector_sz), dtype=torch.float32,
                                        device=device), self._mesh)
            ret._search(emb.cpu().numpy(), k, _MODES[mode])
            if command == _SEARCH:
                self.stats["batches"] += 1
                self.stats["queries"] += rows

    # -- batcher ------------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            n = len(first.texts)
            deadline = time.time() + self.max_wait_ms / 1000.0
            while n < self.max_batch and time.time() < deadline:
                try:
                    req = self._queue.get(timeout=max(0.0, deadline - time.time()))
                    batch.append(req)
                    n += len(req.texts)
                except queue.Empty:
                    break
            try:
                if self._failed is not None:  # the mesh's collectives are out of step
                    raise RuntimeError("the engine serves no more batches: a sharded "
                                       "search failed") from self._failed
                self._run_batch(batch)
            except Exception as e:  # surface errors to every waiter
                logger.exception("retrieval batch failed")
                for req in batch:
                    req.result = e
                    req.event.set()
        if self._mesh is not None and self._failed is None:
            self._send_header(_STOP)

    def _run_batch(self, batch: List[_Request]) -> None:
        all_texts = [t for req in batch for t in req.texts]
        k_eff = self._bucket_topk(max(req.topk for req in batch))
        results = self._retrieve(all_texts, k_eff)
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["queries"] += len(all_texts)
        offset = 0
        for req in batch:
            rows = results[offset:offset + len(req.texts)]
            req.result = [row[:req.topk] for row in rows]
            offset += len(req.texts)
            req.event.set()
