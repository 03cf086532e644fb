"""Exact top-k inner-product search in plain PyTorch (port of
:mod:`kirag_tpu.ops.mips`).

:func:`topk_mips` is a chunked scan: the oracle the exact-search kernels are
held to, and the indexer's search on the CPU. Each chunk is scored with one
matmul (f32 accumulation; queries are cast to the corpus dtype first, as in
the reference) and merged into a running top-k. :func:`topk_mips_onepass`
scores the whole corpus at once and selects in two stages. Ties go to the
lower row id: the running candidates come first in every merge and all
selections are stable sorts.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from kirag_tpu_torch.ops.exact import LANES, stable_topk

# the reference's mask of invalid rows in the one-pass search (finite there,
# since its candidates pass through a one-hot matrix product)
FIN_MIN = -1e30


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


def topk_mips_onepass(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                      valid_rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search in one pass (port of
    ``kirag_tpu.ops.mips.topk_mips_onepass``): one [Q, N] f32 product, the
    top-k of the 128-row group maxima, sorted by group, then the top-k of
    those groups' rows. Rows at or past ``valid_rows`` score FIN_MIN (-1e30),
    as in the reference; slots beyond N hold -inf and row 0. Holds Q x N f32
    scores at once: callers bound Q."""
    n_q = queries.shape[0]
    n = corpus.shape[0]
    n_valid = n if valid_rows is None else int(valid_rows)
    k_eff = min(k, n)
    n_pad = -(-n // LANES) * LANES
    groups = n_pad // LANES
    if n_pad != n:
        corpus = torch.nn.functional.pad(corpus, (0, 0, 0, n_pad - n))
    scores = queries.to(corpus.dtype).to(torch.float32) @ corpus.to(torch.float32).T
    col = torch.arange(n_pad, device=corpus.device)
    scores = torch.where(col < n_valid, scores, FIN_MIN)
    if groups < 2 or k_eff >= groups:  # tiny corpus: direct sort
        vals, idx = stable_topk(scores, k_eff)
    else:
        s3 = scores.view(n_q, groups, LANES)
        gsel = torch.sort(stable_topk(s3.amax(-1), k_eff)[1], dim=-1).values
        cand = torch.gather(s3, 1, gsel[..., None].expand(-1, -1, LANES))
        rows = (gsel[..., None] * LANES + torch.arange(LANES, device=corpus.device))
        vals, pos = stable_topk(cand.reshape(n_q, k_eff * LANES), k_eff)
        idx = torch.gather(rows.reshape(n_q, k_eff * LANES), 1, pos)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
    return vals, idx
