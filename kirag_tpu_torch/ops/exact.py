"""Exact top-k inner-product search (port of :mod:`kirag_tpu.ops.pallas_exact`).

Every variant of the reference, at its defaults (``impl="auto"``,
``select="flat"``), over the port's kernels:

- ``impl="stream"``: one corpus read
  (:func:`~kirag_tpu_torch.kernels.stream_capture`, K1) emits per-chunk
  group maxima and each chunk's top-B groups. ``select="flat"``/``"hier"``
  select over all group maxima and assemble the rows from the capture when
  every selected group was captured; ``"capdom"`` selects in the capture
  domain and proves exactness with a residual check (its assembly is
  :func:`~kirag_tpu_torch.kernels.cap_assemble`, K8, under
  ``KIRAG_CAPDOM_ASSEMBLY=pallas``); ``"merge"`` keeps a running top-br group
  window over the chunks (:func:`~kirag_tpu_torch.kernels.window_merge`, K9).
  A failed check re-selects over all group maxima and re-scores the selected
  groups (:func:`~kirag_tpu_torch.kernels.gather_groups`, K2).
- ``impl="single"``/``"single_strided"``: one corpus read that writes every
  score (:func:`~kirag_tpu_torch.kernels.score_gmax`, K7a), chunk-major or
  row-major; the selected groups are copied out of it
  (:func:`~kirag_tpu_torch.kernels.score_gather`, K7b, or an indexing gather).
- ``impl="twopass"``: K7a without the scores, then K2.

The selections and tails are plain PyTorch. Every kernel scores through one
routine, so all variants return the same values and ids. Results follow
FAISS's flat-index contract: values descending, ties to the lower row id,
which rests on stable sorts (``torch.topk`` promises no tie order, so it is
not used). An int8, packed-int4 or 4-bit PQ corpus with its ``scales`` is
scored by the kernels' quantized formats (K4,
:func:`~kirag_tpu_torch.kernels.exact.quant_scores`). The reference's chunk
clamps (its TPU memory envelope) are not ported.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from kirag_tpu_torch.kernels import exact as K
from kirag_tpu_torch.kernels.exact import FIN_MIN, LANES, check_corpus, pad_rows, quant_scores

QUERY_BLOCK = 256  # the non-stream impls and merge search this many queries at a time
IMPLS = ("auto", "stream", "single", "single_strided", "twopass")
SELECTS = ("flat", "hier", "capdom", "merge")
# merge's window [qb, br, 128] f32 beyond this many bytes degrades to capdom
MERGE_WINDOW_BYTES = 24 * 1024 * 1024
# capdom's candidate assembly: "einsum" (an indexing gather, the reference's
# XLA one-hot product) or "pallas" (K8, cap_assemble). Bitwise the same.
CAPDOM_ASSEMBLY = os.environ.get("KIRAG_CAPDOM_ASSEMBLY", "einsum")
# tests only: take the capture path even when its check fails
_STREAM_ASSERT_CAPTURE = False

_KERNELS = SimpleNamespace(capture=K.stream_capture, gather=K.gather_groups,
                           score=K.score_gmax, score_gather=K.score_gather,
                           assemble=K.cap_assemble, merge=K.window_merge)
_PLAIN = SimpleNamespace(capture=K.stream_capture_plain, gather=K.gather_groups_plain,
                         score=K.score_gmax_plain, score_gather=K.score_gather_plain,
                         assemble=K.cap_assemble_plain, merge=K.window_merge_plain)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` over the last dim, descending, ties to the lower index
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_lastdim(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last dim of ``x`` [Q, W] -> (vals f32, idx
    int64), descending, ties to the lower index (port of
    ``pallas_exact.topk_lastdim``)."""
    return stable_topk(x.to(torch.float32), min(k, x.shape[-1]))


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


def _resolve_impl(impl: str, n_queries: int, rows: int, nbytes: int,
                  chunk_size: int = 8192) -> str:
    """``"auto"`` -> ``"twopass"`` when Q > 512 or Q * chunk > 256 * 16384
    (the reference's memory envelope of its score block), else ``"stream"``;
    any other impl as given (port of ``pallas_exact._resolve_impl``)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|stream|single|single_strided|twopass, got {impl!r}")
    if impl != "auto":
        return impl
    if n_queries > 512 or n_queries * chunk_size > 256 * 16384:
        return "twopass"
    return "stream"


def _check_select(select: str) -> None:
    if select not in SELECTS:
        raise ValueError(f"select must be 'flat', 'hier', 'capdom' or 'merge', got {select!r}")


def _query_block(n_q: int) -> int:
    return QUERY_BLOCK if n_q > QUERY_BLOCK and n_q % QUERY_BLOCK == 0 else n_q


def _merge_geometry(k_eff: int, num_chunks: int, groups_per_chunk: int, n_q: int):
    """(bc, br, qb) of select="merge": the capture budget, the window width
    and the query block (``pallas_exact._merge_geometry``)."""
    bc = _capture_budget(k_eff, num_chunks, groups_per_chunk)
    return bc, max(-(-k_eff // 8) * 8, bc), _query_block(n_q)


def _final_select(cand, gsel, k_eff: int, n_valid: int, select: str = "hier"):
    """Mask invalid rows, exact top-k over the S * 128 candidates (hier for
    select="hier", flat otherwise), map candidate positions back to row ids;
    -inf slots report row 0."""
    n_q, s = gsel.shape
    lane = torch.arange(LANES, device=cand.device)
    rows3 = gsel.long()[..., None] * LANES + lane
    cand = torch.where(rows3 < n_valid, cand.view(n_q, s, LANES),
                       float("-inf")).reshape(n_q, s * LANES)
    if select == "hier":
        vals, pos = hier_topk(cand, k_eff, block=32)
    else:
        vals, pos = topk_lastdim(cand, k_eff)
    idx = torch.gather(gsel.long(), 1, pos // LANES) * LANES + pos % LANES
    return vals, torch.where(torch.isfinite(vals), idx, 0)


def _global_select(gmax: torch.Tensor, k_eff: int, select: str):
    """Top-k groups over all group maxima (gmax [C, G, Q]), ascending gid
    order (so the stable final selection ties to the lower row), with their
    maxima."""
    num_chunks, g_per, n_q = gmax.shape
    gmax_q = gmax.reshape(num_chunks * g_per, n_q).T
    gvals, gsel = hier_topk(gmax_q, k_eff) if select == "hier" else topk_lastdim(gmax_q, k_eff)
    order = torch.argsort(gsel, dim=-1)  # group ids are distinct
    return torch.gather(gsel, 1, order), torch.gather(gvals, 1, order)


def _stream_tail(outs, s: SimpleNamespace, k_eff: int, b: int, select: str, on_miss: str):
    """select="flat"/"hier" after K1 (``pallas_exact._stream_body``'s tail):
    top-k over all group maxima; exact from the capture when every selected
    group was captured (or holds no valid row, max <= FIN_MIN); otherwise,
    under ``on_miss="fallback"``, the selected groups re-scored by K2."""
    gmax, capture, gids = outs[:3]
    g_per = gmax.shape[1]
    gsel, gvals = _global_select(gmax, k_eff, select)
    # group g can only be captured by its own chunk, at one of b slots
    chunk_of = gsel // g_per
    slots = torch.gather(gids.permute(2, 0, 1).long(), 1,
                         chunk_of[..., None].expand(-1, -1, b))     # [Q, k, b]
    eq = slots == gsel[..., None]
    found = eq.any(-1)
    ok = (found | (gvals <= FIN_MIN)).all()
    if _STREAM_ASSERT_CAPTURE or on_miss == "flag" or bool(ok):
        cpos = torch.where(found, chunk_of * b + eq.long().argmax(-1), -1)
        cand = K.cap_assemble_plain(cpos, capture, b)  # a group missed: zeros, as the one-hot
    else:
        cand = s.rescore(gsel)
    vals, idx = _final_select(cand, gsel, k_eff, s.n_valid, select)
    return vals, idx, ok


def _capdom_tail(outs, s: SimpleNamespace, k_eff: int, b: int, on_miss: str):
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
    if _STREAM_ASSERT_CAPTURE or on_miss == "flag" or bool(ok):
        # gid-ascending candidate order (a group is captured at most once per
        # query, so sorting gid * pack + position sorts by gid)
        pack = 1 << (cb - 1).bit_length()
        packed = gids_q * pack + torch.arange(cb, device=gids_q.device)
        sel = torch.sort(torch.gather(packed, 1, cpos), dim=-1).values
        gsel, cpos = sel // pack, sel % pack
        assemble = s.fns.assemble if CAPDOM_ASSEMBLY == "pallas" else K.cap_assemble_plain
        cand = assemble(cpos, capture, b)
    else:
        gsel = _global_select(gmax, k_eff, "hier")[0]
        cand = s.rescore(gsel)
    vals, idx = _final_select(cand, gsel, k_eff, s.n_valid)
    return vals, idx, ok


def _merge_body(s: SimpleNamespace, k_eff: int, bc: int, br: int):
    """select="merge" (port of ``_merge_body``): K1's per-chunk capture, then
    the running window (K9). Exact when the kth window key is strictly above
    every chunk's lost value (an uncaptured or ejected group's maximum); else
    the global selection re-scored by K2, padded to the window width with the
    gid past the corpus (rows >= n_valid, masked)."""
    outs = s.fns.capture(s.queries, s.corpus, s.n_valid, s.chunk, bc, s.scales, s.quant)
    gmax, capture, gids, capmax, resid = outs
    win, wkey, wgid, lost = s.fns.merge(gids, capmax, resid, capture, br, s.groups)
    lost_q = lost[:, 0, :].amax(0)
    kth = stable_topk(wkey, k_eff)[0][:, -1]
    ok = ((kth > lost_q) | (lost_q <= FIN_MIN)).all()
    if _STREAM_ASSERT_CAPTURE or bool(ok):
        cand, gsel = win, wgid
    else:
        gsel = _global_select(gmax, k_eff, "hier")[0]
        cand = s.rescore(gsel)
        pad = br - k_eff
        cand = torch.nn.functional.pad(cand, (0, 0, 0, pad))
        gsel = torch.nn.functional.pad(gsel, (0, pad), value=s.groups)
    return _final_select(cand, gsel, k_eff, s.n_valid)


def _exact_body(s: SimpleNamespace, k_eff: int, select: str, impl: str, on_miss: str):
    """One query block (``pallas_exact._exact_body``) -> (vals, idx, ok)."""
    if select in ("capdom", "merge") and impl != "stream":
        select = "hier"  # capture-domain and window selection need K1's capture
    n_q = s.queries.shape[0]
    num_chunks = s.groups * LANES // s.chunk
    g_per = s.chunk // LANES
    exact = torch.ones((), dtype=torch.bool, device=s.corpus.device)
    if impl == "stream":
        if select == "merge":
            bc, br, qb = _merge_geometry(k_eff, num_chunks, g_per, n_q)
            if qb * br * LANES * 4 > MERGE_WINDOW_BYTES:
                select = "capdom"
            else:  # merge ran its own fallback: exact as returned
                return (*_merge_body(s, k_eff, bc, br), exact)
        b = _capture_budget(k_eff, num_chunks, g_per)
        outs = s.fns.capture(s.queries, s.corpus, s.n_valid, s.chunk, b, s.scales, s.quant)
        if select == "capdom":
            return _capdom_tail(outs, s, k_eff, b, on_miss)
        return _stream_tail(outs, s, k_eff, b, select, on_miss)

    store = {"single": "chunk", "single_strided": "row", "twopass": "none"}[impl]
    scores, gmax = s.fns.score(s.queries, s.corpus, s.n_valid, s.chunk, store, s.scales,
                               s.quant)
    gsel = _global_select(gmax, k_eff, select)[0]
    if impl == "single":
        cand = s.fns.score_gather(scores, gsel)
    elif impl == "single_strided":
        cand = torch.gather(scores.view(n_q, s.groups, LANES), 1,
                            gsel[..., None].expand(-1, -1, LANES))
    else:
        cand = s.rescore(gsel)
    return (*_final_select(cand, gsel, k_eff, s.n_valid, select), exact)


def exact_topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                    chunk_size: int = 4096, valid_rows: Optional[int] = None,
                    select: str = "flat", impl: str = "auto",
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

    ``impl`` ("auto", "stream", "single", "single_strided", "twopass") and
    ``select`` ("flat", "hier", "capdom", "merge") pick the variant (module
    docstring); "capdom" and "merge" on another impl than "stream" select as
    "hier". Every variant returns the same values and ids. Under
    ``on_miss="flag"`` only the stream impl's flat, hier and capdom selections
    can report False; the others are exact as returned. Batches of a
    multiple of 256 queries above 256 run 256 at a time through the
    non-stream impls and merge.

    ``plain=True`` runs the kernels' plain versions on any device: the
    reference the kernels are held to on the card. The chunk is not clamped
    to any memory envelope; a corpus not on the chunk grid is padded per call
    (the indexer pre-pads).
    """
    _check_select(select)
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
    groups = n_pad // LANES
    n_q = queries.shape[0]
    impl = _resolve_impl(impl, _query_block(n_q), n, corpus.numel() * corpus.element_size(),
                         chunk)
    fns = _PLAIN if plain else _KERNELS

    if groups < 2 or k_eff >= groups:
        # tiny corpus: one dense product and a direct sort (the grouped
        # exactness argument needs k < groups), in the kernels' arithmetic
        # (the reference's _dense_scores)
        scores = quant_scores(queries, corpus, scales, quant)
        col = torch.arange(n_pad, device=corpus.device)
        scores = torch.where(col < n_valid, scores, float("-inf"))
        vals, idx = stable_topk(scores, k_eff)
        idx = torch.where(torch.isfinite(vals), idx, 0)
        ok = torch.ones((), dtype=torch.bool, device=corpus.device)
    else:
        def body(q):
            s = SimpleNamespace(queries=q, corpus=corpus, scales=scales, quant=quant,
                                n_valid=n_valid, chunk=chunk, groups=groups, fns=fns,
                                rescore=lambda gsel: fns.gather(q, corpus, gsel, scales, quant))
            return _exact_body(s, k_eff, select, impl, on_miss)

        qb = _query_block(n_q)
        if qb < n_q and (impl != "stream" or select == "merge"):
            # independent query blocks (the reference's lax.map over blocks)
            parts = [body(queries[i:i + qb]) for i in range(0, n_q, qb)]
            vals = torch.cat([p[0] for p in parts])
            idx = torch.cat([p[1] for p in parts])
            ok = torch.stack([p[2] for p in parts]).all()
        else:
            vals, idx, ok = body(queries)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=float("-inf"))
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
    if on_miss == "flag":
        return vals, idx, ok
    return vals, idx
