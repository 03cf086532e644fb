"""Exact top-k inner-product search as a plain chunked scan (port of
:func:`kirag_tpu.ops.mips.topk_mips`).

The oracle the exact-search kernels are held to, and the indexer's search on
the CPU. Each chunk is scored with one matmul (f32 accumulation; queries are
cast to the corpus dtype first, as in the reference) and merged into a
running top-k. Ties go to the lower row id: the running candidates come first
in every merge and all selections are stable sorts.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from kirag_tpu_torch.ops.exact import stable_topk


def topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int,
              chunk_size: int = 262144, valid_rows: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries`` [Q, D] against ``corpus`` [N, D].

    Rows at or past ``valid_rows`` (default N) are padding. Returns
    ``(values [Q, k] f32, indices [Q, k] int64)`` by descending score; slots
    beyond N hold -inf and row 0.
    """
    q = queries.to(corpus.dtype).to(torch.float32)
    return scan_topk(lambda rows: q @ corpus[rows].to(torch.float32).T, queries.shape[0],
                     corpus.shape[0], k, chunk_size, valid_rows, corpus.device)


def scan_topk(score_rows: Callable[[slice], torch.Tensor], n_q: int, n: int, k: int,
              chunk_size: int, valid_rows: Optional[int], device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan behind :func:`topk_mips` and the quantized scans:
    ``score_rows(rows)`` gives the f32 scores [Q, len] of a slice of rows."""
    n_valid = n if valid_rows is None else int(valid_rows)
    k_eff = min(k, n)
    chunk_size = min(chunk_size, n)
    run_vals = torch.full((n_q, k_eff), float("-inf"), device=device)
    run_idx = torch.zeros((n_q, k_eff), dtype=torch.int64, device=device)
    for start in range(0, n, chunk_size):
        rows = torch.arange(start, min(start + chunk_size, n), device=device)
        scores = score_rows(slice(start, start + chunk_size))
        scores = torch.where(rows < n_valid, scores, float("-inf"))
        new_vals, pos = stable_topk(scores, k_eff)
        vals, sel = stable_topk(torch.cat([run_vals, new_vals], dim=-1), k_eff)
        idx = torch.cat([run_idx, rows[pos]], dim=-1)
        run_vals, run_idx = vals, torch.gather(idx, 1, sel)
    if k_eff < k:
        run_vals = torch.nn.functional.pad(run_vals, (0, k - k_eff), value=float("-inf"))
        run_idx = torch.nn.functional.pad(run_idx, (0, k - k_eff))
    return run_vals, run_idx
