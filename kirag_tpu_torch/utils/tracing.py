"""Profiling and tracing (port of :mod:`kirag_tpu.utils.tracing`).

- :func:`trace` — context manager around ``torch.profiler`` (CPU activity,
  and CUDA's when a GPU is present) writing a Chrome trace under
  ``log_dir`` in the TensorBoard profiler plugin's layout
  (``<host>_<pid>.<ms>.pt.trace.json``).
- :func:`annotate` — a named span (``torch.profiler.record_function``) that
  shows up inside device traces.
- :class:`StepTimer` — lightweight step timing that waits on the device of
  the tensors it is given, with percentile summaries and an optional JSONL
  event log; its records and summaries are the reference's.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import time
from typing import Any, Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a torch.profiler trace into ``log_dir``; yields ``log_dir``.
    ``create_perfetto_link`` (the reference's jax.profiler option) has no
    torch counterpart and raises: open the written trace in
    https://ui.perfetto.dev or TensorBoard instead."""
    from torch.profiler import ProfilerActivity, profile

    if create_perfetto_link:
        raise NotImplementedError(
            "trace(create_perfetto_link=True): torch.profiler cannot serve a Perfetto "
            "link; load the Chrome trace written under log_dir into ui.perfetto.dev")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{int(time.time() * 1000)}.pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")


def annotate(name: str):
    """Named span visible in profiler traces (a ``record_function`` range;
    no cost when not tracing)."""
    return torch.profiler.record_function(name)


def _wait_on(block: Any) -> None:
    """Wait for the devices of every tensor in ``block`` (a tensor or a
    dict/list/tuple tree of them): ``torch.cuda.synchronize`` on each CUDA
    device, nothing for CPU tensors."""
    devices = set()

    def walk(node):
        if torch.is_tensor(node):
            if node.device.type == "cuda":
                devices.add(node.device)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(block)
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Wall-clock step timing with percentile summaries.

    Use ``with timer.step("train"):`` around device work; pass ``block=`` a
    tensor (or a tree of them) to wait on (CUDA launches are asynchronous —
    timing without waiting under-reports).
    """

    def __init__(self, log_file: Optional[str] = None):
        self.records: Dict[str, List[float]] = {}
        self.log_file = log_file
        self._fh = open(log_file, "a") if log_file else None

    @contextlib.contextmanager
    def step(self, name: str, block: Any = None):
        t0 = time.perf_counter()
        yield
        if block is not None:
            _wait_on(block)
        dt = time.perf_counter() - t0
        self.records.setdefault(name, []).append(dt)
        if self._fh:
            self._fh.write(json.dumps({"event": name, "seconds": dt,
                                       "ts": time.time()}) + "\n")
            self._fh.flush()

    def summary(self) -> Dict[str, Dict[str, float]]:
        import numpy as np

        out = {}
        for name, times in self.records.items():
            arr = np.asarray(times)
            out[name] = {
                "count": int(arr.size),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
                "total_s": float(arr.sum()),
            }
        return out

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
