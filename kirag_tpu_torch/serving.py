"""Serving: a pre-warmed, thread-safe retrieval engine with micro-batching
(port of :mod:`kirag_tpu.serving`, which is host-only code; the port carries
its own copy so that it imports nothing of the JAX package).

:class:`RetrievalEngine` owns a retriever, warms its search for the top-k
buckets at startup, and serves ``search()`` from any thread through one
worker that coalesces concurrent requests into one encoder batch and one
corpus sweep.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


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
        if warmup:
            self._warmup()
        self._worker.start()

    def _warmup(self) -> None:
        t0 = time.time()
        dummy = ["warmup query"] * 2
        for k in self.topk_buckets:
            self.retriever.batch_retrieve(dummy, topk=k, mode=self.mode)
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
        self._stop.set()
        self._worker.join(timeout=5)

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
                self._run_batch(batch)
            except Exception as e:  # surface errors to every waiter
                logger.exception("retrieval batch failed")
                for req in batch:
                    req.result = e
                    req.event.set()

    def _run_batch(self, batch: List[_Request]) -> None:
        all_texts = [t for req in batch for t in req.texts]
        k_eff = self._bucket_topk(max(req.topk for req in batch))
        results = self.retriever.batch_retrieve(all_texts, topk=k_eff, mode=self.mode)
        self.stats["requests"] += len(batch)
        self.stats["batches"] += 1
        self.stats["queries"] += len(all_texts)
        offset = 0
        for req in batch:
            rows = results[offset:offset + len(req.texts)]
            req.result = [row[:req.topk] for row in rows]
            offset += len(req.texts)
            req.event.set()
