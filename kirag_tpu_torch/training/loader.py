"""Deterministic shuffling data loader with multi-process sharding and
fast-forward resume (port of :mod:`kirag_tpu.training.loader`, numpy only).

Per-epoch seeded permutation, contiguous per-process shards padded by
wrapping to equal batch counts, and ``iter_from`` to skip the batches a
resumed run has already trained on.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 collate_fn: Optional[Callable] = None, drop_last: bool = False,
                 seed: int = 0, process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.process_count > 1:
            # pad to a multiple of process_count by wrapping, like
            # DistributedSampler, so every process sees the same batch count
            total = -(-n // self.process_count) * self.process_count
            if total != n:
                order = np.concatenate([order, order[: total - n]])
            order = order[self.process_index:: self.process_count]
        return order

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        order = self._indices()
        for start in range(0, len(order), self.batch_size):
            batch_idx = order[start: start + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                return
            batch = [self.dataset[int(i)] for i in batch_idx]
            yield self.collate_fn(batch) if self.collate_fn is not None else batch

    def iter_from(self, skip_batches: int) -> Iterator:
        """Resume mid-epoch: skip the first ``skip_batches`` batches without
        materializing them."""
        order = self._indices()
        for start in range(skip_batches * self.batch_size, len(order), self.batch_size):
            batch_idx = order[start: start + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                return
            batch = [self.dataset[int(i)] for i in batch_idx]
            yield self.collate_fn(batch) if self.collate_fn is not None else batch
