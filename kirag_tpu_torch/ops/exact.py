"""Exact top-k inner-product search over the stream-capture kernels.

Port of :mod:`kirag_tpu.ops.pallas_exact` for ``impl="stream"`` with
``select="capdom"``, the path the indexer serves. One corpus read
(:func:`~kirag_tpu_torch.kernels.stream_capture`, K1) emits per-chunk group
maxima and each chunk's top-B groups; the tail selects in that capture
domain and proves exactness with a residual check. When the check fails the
search re-selects over all group maxima and re-scores the selected groups
(:func:`~kirag_tpu_torch.kernels.gather_groups`, K2). The tail is plain
PyTorch. Results follow FAISS's flat-index contract: values descending, ties
to the lower row id, which rests on stable sorts (``torch.topk`` promises no
tie order, so it is not used). An int8, packed-int4 or 4-bit PQ corpus with
its ``scales`` is scored by the kernels' quantized formats (K4,
:func:`~kirag_tpu_torch.kernels.exact.quant_scores`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from kirag_tpu_torch.kernels.exact import (
    FIN_MIN,
    LANES,
    check_corpus,
    gather_groups,
    gather_groups_plain,
    pad_rows,
    quant_scores,
    stream_capture,
    stream_capture_plain,
)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` over the last dim, descending, ties to the lower index
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def hier_topk(x: torch.Tensor, k: int, block: int = 16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last dim of ``x`` [Q, W] by two-level selection
    (port of ``pallas_exact.hier_topk``): every true top-k element lives in a
    ``block``-wide slice whose max is >= the kth value, and at most k slices
    hold top-k elements. Slice ids sort ascending before the gather, so the
    two stable selections compose to lower-index-wins."""
    q, w = x.shape
    x = x.to(torch.float32)
    w1 = -(-w // block)
    if k >= w1 or w <= 2 * block:
        return stable_topk(x, min(k, w))
    if w1 * block != w:
        x = torch.nn.functional.pad(x, (0, w1 * block - w), value=float("-inf"))
    x3 = x.view(q, w1, block)
    _, bsel = stable_topk(x3.amax(-1), k)
    bsel = torch.sort(bsel, dim=-1).values
    cand = torch.gather(x3, 1, bsel[..., None].expand(-1, -1, block))
    lane = torch.arange(block, device=x.device)
    cand_idx = (bsel[..., None] * block + lane).reshape(q, k * block)
    vals, pos = stable_topk(cand.reshape(q, k * block), k)
    return vals, torch.gather(cand_idx, 1, pos)


def _quant_kind(scales: Optional[torch.Tensor], quant: Optional[str] = None) -> str:
    """The corpus format from the operands (port of
    ``pallas_exact._quant_kind``): no scales -> "none", 2-D block scales ->
    "int4" (packed uint8), 1-D row scales -> "int8". "pq4" must be named: its
    [16, D] level table has the shape of a 16-row corpus's int4 scales."""
    if quant is not None:
        return quant
    if scales is None:
        return "none"
    return "int4" if scales.dim() == 2 else "int8"


def _capture_budget(k_eff: int, num_chunks: int, groups_per_chunk: int) -> int:
    """Per-chunk capture width: ~2x the expected count of selected groups per
    chunk, at least 8, at most the chunk's group count (same rule as
    ``pallas_exact._capture_budget``)."""
    b = -(-2 * k_eff // num_chunks)
    b = max(8, -(-b // 8) * 8)
    return min(b, groups_per_chunk)


def _final_select(cand, gsel, k_eff: int, n_valid: int):
    """Mask invalid rows, exact top-k over the k * 128 candidates, map
    candidate positions back to row ids; -inf slots report row 0."""
    n_q, s = gsel.shape
    lane = torch.arange(LANES, device=cand.device)
    rows3 = gsel.long()[..., None] * LANES + lane
    cand = torch.where(rows3 < n_valid, cand.view(n_q, s, LANES),
                       float("-inf")).reshape(n_q, s * LANES)
    vals, pos = hier_topk(cand, k_eff, block=32)
    idx = torch.gather(gsel.long(), 1, pos // LANES) * LANES + pos % LANES
    return vals, torch.where(torch.isfinite(vals), idx, 0)


def _capdom_tail(outs, queries, corpus, k_eff: int, n_valid: int, b: int,
                 on_miss: str, gather):
    """Selection in the capture domain (port of ``_capdom_tail``): top-k over
    the C * B captured maxima; exact if the kth of them is strictly above
    every chunk's uncaptured residual. Otherwise, under ``on_miss="fallback"``,
    re-select over all group maxima and gather the rows by re-scoring."""
    gmax, capture, gids, capmax, resid = outs
    num_chunks, _, n_q = capmax.shape
    cb = num_chunks * b
    capmax_q = capmax.permute(2, 0, 1).reshape(n_q, cb)
    gids_q = gids.permute(2, 0, 1).reshape(n_q, cb).long()
    cvals, cpos = stable_topk(capmax_q, k_eff)
    resid_q = resid[:, 0, :].amax(0)
    ok = ((cvals[:, -1] > resid_q) | (resid_q <= FIN_MIN)).all()
    if on_miss == "flag" or bool(ok):
        # gid-ascending candidate order (a group is captured at most once per
        # query, so sorting gid * pack + position sorts by gid)
        pack = 1 << (cb - 1).bit_length()
        packed = gids_q * pack + torch.arange(cb, device=gids_q.device)
        sel = torch.sort(torch.gather(packed, 1, cpos), dim=-1).values
        gsel, cpos = sel // pack, sel % pack
        qrow = torch.arange(n_q, device=capture.device)[:, None]
        cand = capture.view(num_chunks, n_q, b, LANES)[cpos // b, qrow, cpos % b]
    else:
        groups = gmax.shape[0] * gmax.shape[1]
        _, gsel = hier_topk(gmax.reshape(groups, n_q).T, k_eff)
        gsel = torch.sort(gsel, dim=-1).values
        cand = gather(queries, corpus, gsel)
    vals, idx = _final_select(cand, gsel, k_eff, n_valid)
    return vals, idx, ok


def exact_topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    chunk_size: int = 4096, valid_rows: Optional[int] = None,
                    select: str = "capdom", impl: str = "stream",
                    on_miss: str = "fallback", plain: bool = False,
                    scales: Optional[torch.Tensor] = None, quant: Optional[str] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Exact top-k inner-product search (port of
    ``kirag_tpu.ops.pallas_exact.exact_topk_mips``).

    Returns ``(vals [Q, k] f32, idx [Q, k] int64)``, descending, ties to the
    lower row id; slots beyond the corpus hold -inf and row 0. With
    ``on_miss="flag"`` it returns ``(vals, idx, ok)``: the capture result
    always, and ``ok`` (a bool tensor) says whether it is exact; a caller
    that gets False re-runs with ``on_miss="fallback"``. Scores are f32
    products of the stored values with f32 sums.

    ``scales`` makes the corpus quantized: [N] f32 row scales of an int8
    corpus, or [N, D/128] f32 block scales of a packed-int4 uint8 corpus
    [N, D/2] (``quant`` is inferred from them), or with ``quant="pq4"`` the
    [16, D] level table of 4-bit PQ codes [N, m/2].

    ``plain=True`` runs the kernels' plain versions on any device: the
    reference the kernels are held to on the card. The chunk is not clamped
    to any memory envelope; a corpus not on the chunk grid is padded per call
    (the indexer pre-pads).
    """
    if impl != "stream":
        raise NotImplementedError(
            f"impl={impl!r}: only 'stream' is ported (ROADMAP.md §A, exact-search "
            "variants K7)")
    if select != "capdom":
        raise NotImplementedError(
            f"select={select!r}: only 'capdom' is ported (ROADMAP.md §A, "
            "selection variants K8/K9)")
    if on_miss not in ("fallback", "flag"):
        raise ValueError(f"on_miss must be fallback|flag, got {on_miss!r}")
    quant = _quant_kind(scales, quant)
    check_corpus(corpus, scales, quant)
    n = corpus.shape[0]
    n_valid = n if valid_rows is None else int(valid_rows)
    k_eff = min(k, n)
    chunk = max(LANES, chunk_size // LANES * LANES)
    chunk = min(chunk, -(-n // LANES) * LANES)
    n_pad = -(-n // chunk) * chunk
    if n_pad != n:
        corpus, scales = pad_rows(corpus, scales, n_pad, quant)
    capture_fn = stream_capture_plain if plain else stream_capture
    gather_fn = functools.partial(gather_groups_plain if plain else gather_groups,
                                  scales=scales, quant=quant)
    num_chunks = n_pad // chunk
    groups = n_pad // LANES
    ok = torch.ones((), dtype=torch.bool, device=corpus.device)

    if groups < 2 or k_eff >= groups:
        # tiny corpus: one dense product and a direct sort (the grouped
        # exactness argument needs k < groups), in the kernels' arithmetic
        # (the reference's _dense_scores)
        scores = quant_scores(queries, corpus, scales, quant)
        col = torch.arange(n_pad, device=corpus.device)
        scores = torch.where(col < n_valid, scores, float("-inf"))
        vals, idx = stable_topk(scores, k_eff)
        idx = torch.where(torch.isfinite(vals), idx, 0)
    else:
        b = _capture_budget(k_eff, num_chunks, chunk // LANES)
        outs = capture_fn(queries, corpus, n_valid, chunk, b, scales, quant)
        vals, idx, ok = _capdom_tail(outs, queries, corpus, k_eff, n_valid, b,
                                     on_miss, gather_fn)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
    if on_miss == "flag":
        return vals, idx, ok
    return vals, idx
