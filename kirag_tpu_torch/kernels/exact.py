"""Wrappers of the exact-search kernels, each beside its plain version.

``stream_capture`` (K1, ``csrc/stream_capture.cu``) and ``gather_groups``
(K2, ``csrc/gather_groups.cu``) take tensors on one device. On a CUDA tensor
a wrapper launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version, which computes the same function with f32 products and f32
sums (a CUDA kernel cannot run on the CPU). Each launch adds one to the
wrapper's count in :func:`~kirag_tpu_torch.kernels.common.launch_counts`,
under ``stream_capture``/``gather_groups`` for a float corpus and with an
``_int8``/``_int4``/``_pq4`` suffix for a quantized one.

Both kernels score a float32 or bfloat16 corpus, or a quantized one (K4, the
in-kernel dequant of ``kirag_tpu.ops.pallas_exact._chunk_scores``), named by
``quant``:

- ``"int8"``: int8 codes [N, D] and f32 row scales [N];
- ``"int4"``: packed uint8 [N, D/2] (byte j: dim j in the low nibble, dim
  j + D/2 in the high one) and f32 block scales [N, D/128], level n - 7.5;
- ``"pq4"``: 4-bit product-quantization codes, packed uint8 [N, m/2] (byte
  t: subspace t in the low nibble, t + m/2 in the high one), and the f32
  level table [16, D] (:func:`kirag_tpu_torch.ops.pq.pq_level_table`) in the
  ``scales`` slot. The table belongs to every row: it is not padded or
  sliced with them.

:func:`quant_scores` states their arithmetic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from kirag_tpu_torch.kernels.build import load_library
from kirag_tpu_torch.kernels.common import count_launch, on_cpu, raise_on

LANES = 128
FIN_MIN = -1e30
INT4_BLOCK = 128
PQ_LEVELS = 16
# the kernels' corpus formats (csrc/score.cuh's with_format; pq4 adds
# log2(D / m) to its kind)
_KIND = {torch.float32: 0, torch.bfloat16: 1, "int8": 2, "int4": 3, "pq4": 4}


def _corpus_dim(corpus: torch.Tensor, scales: Optional[torch.Tensor], quant: str) -> int:
    """The vector depth D of a corpus stored in ``quant``'s format."""
    if quant == "pq4":
        return scales.shape[1]
    return 2 * corpus.shape[1] if quant == "int4" else corpus.shape[1]


def row_scales(scales: Optional[torch.Tensor], rows, quant: str) -> Optional[torch.Tensor]:
    """The scales of the corpus rows ``rows``: the pq4 level table belongs
    to every row and is returned whole."""
    return scales if scales is None or quant == "pq4" else scales[rows]


def pad_rows(corpus: torch.Tensor, scales: Optional[torch.Tensor], n_pad: int,
             quant: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``corpus`` and its scales with zero rows appended up to ``n_pad``
    rows (the pq4 level table stays whole, as in :func:`row_scales`)."""
    extra = n_pad - corpus.shape[0]
    corpus = torch.nn.functional.pad(corpus, (0, 0, 0, extra))
    if scales is not None and quant != "pq4":
        scales = torch.nn.functional.pad(scales, (0, 0) * (scales.dim() - 1) + (0, extra))
    return corpus, scales


def check_corpus(corpus: torch.Tensor, scales: Optional[torch.Tensor], quant: str) -> None:
    """Raise unless ``corpus`` and ``scales`` are a contiguous corpus in
    ``quant``'s format."""
    if corpus.dim() != 2 or not corpus.is_contiguous():
        raise ValueError("corpus must be a contiguous [N, D] matrix")
    if quant == "none":
        if corpus.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"corpus must be float32 or bfloat16, got {corpus.dtype}")
        if scales is not None:
            raise ValueError("a float corpus takes no scales")
        return
    if quant == "pq4":
        if corpus.dtype != torch.uint8:
            raise TypeError(f"a pq4 corpus is torch.uint8 codes, got {corpus.dtype}")
        m = 2 * corpus.shape[1]
        if (scales is None or scales.dim() != 2 or scales.shape[0] != PQ_LEVELS
                or scales.shape[1] % m or not scales.is_contiguous()):
            raise ValueError(f"pq4 needs a contiguous [{PQ_LEVELS}, D] level table with "
                             f"D % {m} == 0 for codes {tuple(corpus.shape)}, got "
                             f"{None if scales is None else tuple(scales.shape)}")
        if scales.dtype != torch.float32:
            raise TypeError(f"the level table must be float32, got {scales.dtype}")
        return
    want = {"int8": (torch.int8, (corpus.shape[0],)),
            "int4": (torch.uint8, (corpus.shape[0], 2 * corpus.shape[1] // INT4_BLOCK))}
    if quant not in want:
        raise ValueError(f"quant must be none|int8|int4|pq4, got {quant!r}")
    dtype, shape = want[quant]
    if corpus.dtype != dtype:
        raise TypeError(f"a {quant} corpus is {dtype}, got {corpus.dtype}")
    if quant == "int4" and (2 * corpus.shape[1]) % (2 * INT4_BLOCK):
        raise ValueError(f"int4 corpora need D % 256 == 0, got D={2 * corpus.shape[1]}")
    if scales is None or tuple(scales.shape) != shape or not scales.is_contiguous():
        raise ValueError(f"a {quant} corpus of {corpus.shape[0]} rows needs contiguous "
                         f"scales of shape {shape}, got "
                         f"{None if scales is None else tuple(scales.shape)}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")


MAX_INT4_DIM = 2048  # csrc/score.cuh's with_format: int4 D = 256 * NBH, NBH = 1 .. 8
MAX_PQ_DIM = 2048    # pq4: the table ([m][16][D/m] bf16, 32 bytes a dim) in shared memory
PQ_DS = (1, 2, 4, 8)  # pq4's D / m that with_format instantiates


def pq_kernel_geometry_error(d: int, m: int) -> Optional[str]:
    """Why the CUDA kernels cannot score a pq4 corpus of depth d with m
    subquantizers, or None when they can: D / m in PQ_DS, m / 2 a multiple of
    16 (16-byte code reads), D at most MAX_PQ_DIM."""
    if m < 2 or d % m or d // m not in PQ_DS or (m // 2) % 16 or d > MAX_PQ_DIM:
        return (f"the pq4 kernels take D / m in {PQ_DS}, m / 2 % 16 == 0 and D <= "
                f"{MAX_PQ_DIM}, got D={d}, m={m}")
    return None


def _check_kernel_operands(corpus, scales, quant: str) -> None:
    """What the CUDA kernels take beyond the plain versions: 16-byte vector
    reads of the corpus rows, int4 depths up to MAX_INT4_DIM and pq4's
    geometries."""
    d = _corpus_dim(corpus, scales, quant)
    if quant == "pq4":
        why = pq_kernel_geometry_error(d, 2 * corpus.shape[1])
        if why is not None or corpus.data_ptr() % 16:
            raise ValueError(why or "the CUDA kernels need a 16-byte aligned corpus")
        return
    vec = 16 if quant == "int8" else 8
    if d % vec or corpus.data_ptr() % 16:
        raise ValueError(f"the CUDA kernels need D % {vec} == 0 and a 16-byte aligned "
                         f"corpus, got D={d}")
    if quant == "int4" and d > MAX_INT4_DIM:
        raise ValueError(f"the int4 kernels take D = 256 .. {MAX_INT4_DIM} in steps of "
                         f"256, got D={d}")


# the pq4 kernels' copy of each level table, made at its first launch and
# kept while the table lives and is not written
_PQ_TABLES = WeakTensorKeyDictionary()


def _pq_kernel_table(scales: torch.Tensor, m: int) -> torch.Tensor:
    """The [16, D] level table rounded to bf16 and laid out [m][16][D/m]
    (csrc/score.cuh's table_bytes), built once per table."""
    hit = _PQ_TABLES.get(scales)
    if hit is not None and hit[0] == scales._version:
        return hit[1]
    ds = scales.shape[1] // m
    table = scales.to(torch.bfloat16).view(PQ_LEVELS, ds, m).permute(2, 0, 1).contiguous()
    _PQ_TABLES[scales] = (scales._version, table)
    return table


def _kernel_args(queries, corpus, scales, quant: str):
    """The kernel's queries (f32; rounded to bf16 first for a quantized
    corpus, as the reference does), format code and scales (pq4: the
    kernels' copy of the level table, :func:`_pq_kernel_table`)."""
    if quant == "none":
        return queries.to(torch.float32).contiguous(), _KIND[corpus.dtype], None
    q = queries.to(torch.bfloat16).to(torch.float32).contiguous()
    if quant == "pq4":
        m = 2 * corpus.shape[1]
        ds = scales.shape[1] // m
        return q, _KIND[quant] + ds.bit_length() - 1, _pq_kernel_table(scales, m)
    return q, _KIND[quant], scales


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_name(kernel: str, quant: str) -> str:
    return kernel if quant == "none" else f"{kernel}_{quant}"


def quant_scores(queries: torch.Tensor, corpus: torch.Tensor,
                 scales: Optional[torch.Tensor], quant: str) -> torch.Tensor:
    """f32 scores [Q, rows] of ``corpus`` rows stored in ``quant``'s format:
    the plain statement of K4 (``pallas_exact._chunk_scores``).

    "none": f32 products of the stored values, f32 sums. "int8": queries
    rounded to bf16, their f32 dot product with the codes, times the row
    scale. "int4": queries rounded to bf16; per 128-dim block b the f32 dot
    product p_b with the levels n - 7.5, then ``out = p_0 * s_0``,
    ``out = out + p_b * s_b`` in block order (the reference's rounding).
    "pq4": queries and the level table rounded to bf16; per component j and
    nibble plane p the f32 dot product p_(j,p) of the query dims
    ``[j*m + p*m/2, +m/2)`` with the codes' levels there, then
    ``out = p_(0,lo)``, ``out = out + p_(0,hi)``, ``out = out + p_(1,lo)``, ...
    """
    if quant == "none":
        return queries.to(torch.float32) @ corpus.to(torch.float32).T
    q = queries.to(torch.bfloat16).to(torch.float32)
    if quant == "pq4":
        m2 = corpus.shape[1]
        m = 2 * m2
        levels = scales.to(torch.bfloat16).to(torch.float32)               # [16, D]
        codes = corpus.long()
        col = torch.arange(m2, device=corpus.device)
        out = None
        for j in range(levels.shape[1] // m):
            for p, nib in ((0, codes & 15), (1, codes >> 4)):
                off = j * m + p * m2
                dec = levels[:, off:off + m2].T.reshape(-1)[col * PQ_LEVELS + nib]  # [n, m2]
                part = q[:, off:off + m2] @ dec.T
                out = part if out is None else out + part
        return out
    if quant == "int8":
        return (q @ corpus.to(torch.float32).T) * scales.to(torch.float32)[None, :]
    n, half = corpus.shape
    nb = 2 * half // INT4_BLOCK
    levels = torch.cat([corpus & 15, corpus >> 4], dim=1).to(torch.float32) - 7.5
    p = torch.bmm(q.view(-1, nb, INT4_BLOCK).transpose(0, 1),               # [NB, Q, 128]
                  levels.view(n, nb, INT4_BLOCK).permute(1, 2, 0))          # [NB, 128, n]
    p = p * scales.to(torch.float32).T[:, None, :]
    out = p[0]
    for b in range(1, nb):
        out = out + p[b]
    return out


# ------------------------------------------------------------ stream_capture


def _capture_geometry(queries, corpus, scales, quant: str, chunk_size: int, b: int):
    check_corpus(corpus, scales, quant)
    if queries.dim() != 2 or queries.shape[1] != _corpus_dim(corpus, scales, quant) or \
            queries.shape[0] < 1:
        raise ValueError(f"queries {tuple(queries.shape)} do not match a {quant} corpus "
                         f"{tuple(corpus.shape)}")
    n = corpus.shape[0]
    if chunk_size % LANES or chunk_size <= 0 or n % chunk_size or n == 0:
        raise ValueError(f"corpus rows {n} must be a positive multiple of "
                         f"chunk_size {chunk_size}, itself a multiple of {LANES}")
    groups_per_chunk = chunk_size // LANES
    if not 1 <= b <= groups_per_chunk:
        raise ValueError(f"capture budget {b} outside [1, {groups_per_chunk}]")
    return n // chunk_size, groups_per_chunk


def _tensors(*tensors):
    return [t for t in tensors if t is not None]


def stream_capture(queries: torch.Tensor, corpus: torch.Tensor, valid_rows: int,
                   chunk_size: int, b: int, scales: Optional[torch.Tensor] = None,
                   quant: str = "none") -> Tuple[torch.Tensor, ...]:
    """Per-chunk group maxima and top-``b`` group capture (K1).

    ``corpus`` [C * chunk_size, *] in ``quant``'s format (float32 or bfloat16
    [., D] for "none"), ``queries`` [Q, D]. Returns ``(gmax [C, G, Q] f32,
    capture [C, Q, b * 128] f32, gids [C, b, Q] int32, capmax [C, b, Q] f32,
    resid [C, 1, Q] f32)`` with G = chunk_size / 128: the outputs of
    ``kirag_tpu.ops.pallas_exact._stream_kernel`` under ``capdom``. Rows at
    or past ``valid_rows`` count as FIN_MIN in the maxima; captured scores
    stay raw.
    """
    num_chunks, groups_per_chunk = _capture_geometry(queries, corpus, scales, quant,
                                                     chunk_size, b)
    if on_cpu(queries, *_tensors(corpus, scales)):
        return stream_capture_plain(queries, corpus, valid_rows, chunk_size, b, scales, quant)
    _check_kernel_operands(corpus, scales, quant)
    lib = load_library()
    n_q, d = queries.shape
    q, kind, operand = _kernel_args(queries, corpus, scales, quant)
    dev = corpus.device
    gmax = torch.empty((num_chunks, groups_per_chunk, n_q), dtype=torch.float32, device=dev)
    capture = torch.empty((num_chunks, n_q, b * LANES), dtype=torch.float32, device=dev)
    gids = torch.empty((num_chunks, b, n_q), dtype=torch.int32, device=dev)
    capmax = torch.empty((num_chunks, b, n_q), dtype=torch.float32, device=dev)
    resid = torch.empty((num_chunks, 1, n_q), dtype=torch.float32, device=dev)
    # queries per thread (2 * qpt per block). On an H100 at 1M x 1024, 4
    # queries per block were fastest for Q <= 8 and 8 per block within 17% of
    # the best for Q = 16-64 (tiles of 2, 4, 8 and 16 queries timed)
    qpt = 2 if n_q <= 8 else 4
    with torch.cuda.device(dev):
        err = lib.kirag_stream_capture(
            q.data_ptr(), corpus.data_ptr(), kind, _ptr(operand),
            gmax.data_ptr(), capture.data_ptr(), gids.data_ptr(), capmax.data_ptr(),
            resid.data_ptr(), n_q, d, num_chunks, chunk_size, b, int(valid_rows), qpt,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib, "stream_capture")
    count_launch(_launch_name("stream_capture", quant))
    return gmax, capture, gids, capmax, resid


def stream_capture_plain(queries: torch.Tensor, corpus: torch.Tensor, valid_rows: int,
                         chunk_size: int, b: int, scales: Optional[torch.Tensor] = None,
                         quant: str = "none") -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`stream_capture`, same contract."""
    num_chunks, groups_per_chunk = _capture_geometry(queries, corpus, scales, quant,
                                                     chunk_size, b)
    n_q = queries.shape[0]
    dev = corpus.device
    scores = torch.empty((num_chunks, n_q, chunk_size), dtype=torch.float32, device=dev)
    for c in range(num_chunks):
        rows = slice(c * chunk_size, (c + 1) * chunk_size)
        scores[c] = quant_scores(queries, corpus[rows], row_scales(scales, rows, quant), quant)
    rows = torch.arange(num_chunks * chunk_size, device=dev).view(num_chunks, 1, chunk_size)
    masked = torch.where(rows < valid_rows, scores, FIN_MIN)
    gmax = masked.view(num_chunks, n_q, groups_per_chunk, LANES).amax(-1).clamp_min(FIN_MIN)
    # peel order: larger maximum first, ties to the lower group id
    order_v, order_i = torch.sort(gmax, dim=-1, descending=True, stable=True)
    sel = order_i[..., :b]                                        # [C, Q, b]
    if b < groups_per_chunk:
        resid = order_v[..., b]
    else:
        resid = torch.full((num_chunks, n_q), float("-inf"), device=dev)
    capture = torch.gather(scores.view(num_chunks, n_q, groups_per_chunk, LANES), 2,
                           sel[..., None].expand(-1, -1, -1, LANES))
    gids = sel + torch.arange(num_chunks, device=dev).view(-1, 1, 1) * groups_per_chunk
    return (gmax.transpose(1, 2).contiguous(),
            capture.reshape(num_chunks, n_q, b * LANES),
            gids.to(torch.int32).transpose(1, 2).contiguous(),
            order_v[..., :b].transpose(1, 2).contiguous(),
            resid[:, None, :].contiguous())


# ------------------------------------------------------------- gather_groups


def _check_gather(queries, corpus, gsel, scales, quant: str) -> None:
    check_corpus(corpus, scales, quant)
    if corpus.shape[0] % LANES:
        raise ValueError(f"corpus rows {corpus.shape[0]} must be a multiple of {LANES}")
    if queries.dim() != 2 or queries.shape[1] != _corpus_dim(corpus, scales, quant):
        raise ValueError(f"queries {tuple(queries.shape)} do not match a {quant} corpus "
                         f"{tuple(corpus.shape)}")
    if gsel.dim() != 2 or gsel.shape[0] != queries.shape[0] or gsel.shape[1] < 1:
        raise ValueError(f"gsel {tuple(gsel.shape)} must be [Q, k] for "
                         f"{queries.shape[0]} queries")
    if gsel.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gsel must be int32 or int64, got {gsel.dtype}")


def gather_groups(queries: torch.Tensor, corpus: torch.Tensor, gsel: torch.Tensor,
                  scales: Optional[torch.Tensor] = None, quant: str = "none") -> torch.Tensor:
    """Scores of each query's selected 128-row groups (K2).

    ``gsel`` [Q, k] group ids -> ``cand`` [Q, k, 128] f32 with
    ``cand[q, j, l]`` the score of query q and row ``gsel[q, j] * 128 + l``
    (:func:`quant_scores`'s arithmetic); a group id outside the corpus gives
    zeros (the reference's one-hot semantics).
    """
    _check_gather(queries, corpus, gsel, scales, quant)
    if on_cpu(queries, gsel, *_tensors(corpus, scales)):
        return gather_groups_plain(queries, corpus, gsel, scales, quant)
    _check_kernel_operands(corpus, scales, quant)
    lib = load_library()
    n_q, d = queries.shape
    k = gsel.shape[1]
    q, kind, operand = _kernel_args(queries, corpus, scales, quant)
    g32 = gsel.to(torch.int32).contiguous()
    cand = torch.empty((n_q, k, LANES), dtype=torch.float32, device=corpus.device)
    with torch.cuda.device(corpus.device):
        err = lib.kirag_gather_groups(
            q.data_ptr(), corpus.data_ptr(), kind, _ptr(operand), g32.data_ptr(),
            cand.data_ptr(), n_q, d, k, corpus.shape[0],
            torch.cuda.current_stream(corpus.device).cuda_stream)
    raise_on(err, lib, "gather_groups")
    count_launch(_launch_name("gather_groups", quant))
    return cand


def gather_groups_plain(queries: torch.Tensor, corpus: torch.Tensor, gsel: torch.Tensor,
                        scales: Optional[torch.Tensor] = None,
                        quant: str = "none") -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_groups`, same contract."""
    _check_gather(queries, corpus, gsel, scales, quant)
    n_q, k = gsel.shape
    dev = corpus.device
    inside = (gsel >= 0) & (gsel < corpus.shape[0] // LANES)            # [Q, k]
    rows = gsel.long()[..., None] * LANES + torch.arange(LANES, device=dev)
    rows = torch.where(inside[..., None], rows, 0).reshape(n_q, k * LANES)
    cand = torch.stack([
        quant_scores(queries[i:i + 1], corpus[rows[i]], row_scales(scales, rows[i], quant),
                     quant)[0]
        for i in range(n_q)])
    return torch.where(inside[..., None], cand.view(n_q, k, LANES), 0.0)
