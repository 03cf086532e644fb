"""Group-sampled approximate top-k inner-product search (port of
:mod:`kirag_tpu.ops.pallas_mips`, one device).

One corpus read (:func:`~kirag_tpu_torch.kernels.group_max`, K5) gives each
128-row group's ``W`` best rows; the top-k is taken over those ``Q x G x W``
candidates. Exact for k = 1; at W = 1 recall@k is about 1 - k(k-1)*64/N for a
corpus in random row order, W = 2 squares the dominant miss (more than W of
the true top-k in one group) away, and W = 128 is exact search. Row order
correlated with similarity (an article's passages in consecutive rows) lowers
recall: shuffle the rows upstream (``TorchIndexer(shuffle_rows=True)``).

The reference pads the corpus to its 2048-row chunk inside each call; here
the corpus needs whole 128-row groups only (the indexer pads to them once,
and a CUDA corpus off that grid is refused rather than copied per call).
Groups made of padding give -inf candidates that report row 0, so the result
is the same either way. ``sharded_approx_topk_mips`` is not ported
(ROADMAP.md §A: multi-GPU index).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kirag_tpu_torch.kernels.approx import group_max, group_max_plain
from kirag_tpu_torch.kernels.exact import LANES
from kirag_tpu_torch.ops.exact import _quant_kind, stable_topk


def grouped_max_scores(queries: torch.Tensor, corpus: torch.Tensor, winners: int = 1,
                       scales: Optional[torch.Tensor] = None, quant: Optional[str] = None,
                       plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-128-row-group top-``winners`` (port of
    ``pallas_mips.grouped_max_scores``): ``(gmax [Q, W, N/128] f32,
    gidx [Q, W, N/128] int32)``, lanes within the group, W descending.
    ``scales`` makes the corpus int8 ([N] row scales) or packed int4
    ([N, D/128] block scales); N must be a multiple of 128. ``plain=True``
    runs the kernel's plain version on any device."""
    quant = _quant_kind(scales, quant)
    fn = group_max_plain if plain else group_max
    return fn(queries, corpus, winners, scales, quant)


def approx_topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     valid_rows: Optional[int] = None,
                     scales: Optional[torch.Tensor] = None, row_offset: int = 0,
                     winners_per_group: int = 1, quant: Optional[str] = None,
                     plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-sampled top-k (port of ``pallas_mips.approx_topk_mips``).

    Returns ``(vals [Q, k] f32, idx [Q, k] int64)``, descending. Candidates
    are flattened group-major, so equal values go to the lower group, then
    to the earlier-peeled winner. Rows at or past ``valid_rows`` are masked
    to -inf after the peel, as in the reference: a zero pad row may take a
    winner slot of a partly filled last group from a real row that scores
    below 0. Slots without a finite value report row 0; ``row_offset``
    shifts the other row ids. A CPU corpus not on the 128-row grid is
    padded with zero rows per call; a CUDA one raises, since the copy would
    cost a corpus per search (the indexer pads once).
    """
    quant = _quant_kind(scales, quant)
    n = corpus.shape[0]
    n_valid = n if valid_rows is None else int(valid_rows)
    n_pad = max(-(-n // LANES) * LANES, LANES)
    if n_pad != n:  # scales pad with their rows
        if corpus.is_cuda:
            raise ValueError(f"approx_topk_mips: a CUDA corpus needs a positive multiple of "
                             f"{LANES} rows, got {n}; pad it once (TorchIndexer.to_device)")
        corpus = torch.nn.functional.pad(corpus, (0, 0, 0, n_pad - n))
        if scales is not None:
            scales = torch.nn.functional.pad(scales, (0, 0) * (scales.dim() - 1)
                                             + (0, n_pad - n))
    gmax, gidx = grouped_max_scores(queries, corpus, winners_per_group, scales, quant, plain)
    n_q, w, groups = gmax.shape
    group_base = torch.arange(groups, device=gmax.device) * LANES
    rows = group_base[None, None, :] + gidx.long()                   # [Q, W, G]
    gmax = torch.where(rows < n_valid, gmax, float("-inf"))
    cand = gmax.transpose(1, 2).reshape(n_q, groups * w)
    crow = rows.transpose(1, 2).reshape(n_q, groups * w)
    k_eff = min(k, groups * w)
    vals, pos = stable_topk(cand, k_eff)
    idx = torch.gather(crow, 1, pos) + row_offset
    idx = torch.where(torch.isfinite(vals), idx, 0)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
    return vals, idx
