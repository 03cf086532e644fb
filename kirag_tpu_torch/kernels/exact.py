"""Wrappers of the exact-search kernels, each beside its plain version.

- ``stream_capture`` (K1, ``csrc/stream_capture.cu``): group maxima and each
  chunk's top-B group capture, one corpus read;
- ``gather_groups`` (K2, ``csrc/gather_groups.cu``): re-scores selected
  groups;
- ``score_gmax`` (K7a, ``csrc/score_gmax.cu``): every score and the group
  maxima, the scores written chunk-major, row-major or not at all;
- ``score_gather`` (K7b) and ``cap_assemble`` (K8), both
  ``csrc/copy_groups.cu``: copy selected 128-score groups out of K7a's
  scores or K1's capture, one launch a call that reads int32 or int64
  indices as given (no cast), a warp a (query, slot) pair, cut by
  :func:`copy_plan`;
- ``window_merge`` (K9, ``csrc/window_merge.cu``): the running top-``br``
  group window of ``select="merge"`` over K1's per-chunk capture.

The wrappers take tensors on one device. On a CUDA tensor a wrapper launches
its kernel or raises; on a CPU tensor it runs its plain PyTorch version,
which computes the same function with f32 products and f32 sums (a CUDA
kernel cannot run on the CPU). Each launch adds one to the wrapper's count in
:func:`~kirag_tpu_torch.kernels.common.launch_counts`, under the kernel's
name, with an ``_int8``/``_int4``/``_pq4`` suffix for the kernels that score
a quantized corpus (K1, K2, K7a).

The scoring kernels take a float32 or bfloat16 corpus, or a quantized one
(K4, the in-kernel dequant of ``kirag_tpu.ops.pallas_exact._chunk_scores``),
named by ``quant``. Float32 and bfloat16 corpora score in
``csrc/score.cuh``'s fma order on the CUDA cores, int8, int4 and pq4 ones in
its mma order on the tensor cores (codes decoded exactly to bf16, pq4's
through its level table in shared memory; every kernel the same instruction
over the same k-steps, so K1, K2, K5 and K7a agree bitwise for each
format):

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

import dataclasses
import functools
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


MAX_INT4_DIM = 2048  # csrc/score.cuh's MAX_INT4_DIM: int4 D = 256 .. 2048 in steps of 256
MAX_PQ_DIM = 2048    # pq4: the level table and a query tile beside the ring in shared memory
PQ_DS = (1, 2, 4, 8)  # pq4's D / m that with_format instantiates


def pq_kernel_geometry_error(d: int, m: int) -> Optional[str]:
    """Why the CUDA kernels cannot score a pq4 corpus of depth d with m
    subquantizers, or None when they can: D / m in PQ_DS, m / 2 a multiple of
    16 (whole k-steps of 16 bytes), D at most MAX_PQ_DIM."""
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
# kept while the table lives and is not written (with the m it was made for)
_PQ_TABLES = WeakTensorKeyDictionary()


def pq_table_geometry(ds: int) -> Tuple[int, int, int, int, int]:
    """csrc/score.cuh's pq4 table layout at D / m = ds: (U components an
    entry holds, H entries a (subspace, code), EB bytes an entry, W values
    of t sharing a 128-byte slot, and Q / m: the bytes of one t // W, per
    subquantizer)."""
    u = 1 if ds == 1 else 2
    h = ds // u
    eb = 2 * u
    w = 128 // (16 * eb)
    return u, h, eb, w, 32 * h


def pq_table_bytes(d: int, m: int) -> int:
    """Bytes of the kernels' level table of depth d with m subquantizers
    (32 D)."""
    u, h, eb, w, q_per_m = pq_table_geometry(d // m)
    return 4 // w * q_per_m * m


def pq_table_offsets(d: int, m: int, s, h, n):
    """The byte of entry h of subspace s and code n in the kernels' table
    (csrc/score.cuh): with t = s // 4 % 4, e = s % 4, s' = s // 16,
    ``(t // W) Q + ((4 s' + e) H + h) 128 + (t % W) 16 EB + n EB``."""
    _, hh, eb, w, q_per_m = pq_table_geometry(d // m)
    t, e, s16 = s // 4 % 4, s % 4, s // 16
    return (t // w) * q_per_m * m + ((4 * s16 + e) * hh + h) * 128 + (t % w) * 16 * eb + n * eb


def _pq_kernel_table(scales: torch.Tensor, m: int) -> torch.Tensor:
    """The [16, D] level table rounded to bf16 in csrc/score.cuh's pq4 layout
    (bf16 [pq_table_bytes / 2]): entry h of subspace s and code n
    (:func:`pq_table_offsets`) holds ``L[n, (U h + u) m + s]`` at its bf16 u;
    built once per table and m."""
    hit = _PQ_TABLES.get(scales)
    if hit is not None and hit[:2] == (scales._version, m):
        return hit[2]
    d = scales.shape[1]
    u, h = pq_table_geometry(d // m)[:2]
    dev = scales.device
    s = torch.arange(m, device=dev).view(m, 1, 1, 1)
    hh = torch.arange(h, device=dev).view(1, h, 1, 1)
    n = torch.arange(PQ_LEVELS, device=dev).view(1, 1, PQ_LEVELS, 1)
    uu = torch.arange(u, device=dev).view(1, 1, 1, u)
    byte = pq_table_offsets(d, m, s, hh, n) + 2 * uu
    table = torch.zeros(pq_table_bytes(d, m) // 2, dtype=torch.bfloat16, device=dev)
    table[(byte // 2).reshape(-1)] = scales.to(torch.bfloat16)[n, (hh * u + uu) * m + s].reshape(-1)
    _PQ_TABLES[scales] = (scales._version, m, table)
    return table


def _kernel_args(queries, corpus, scales, quant: str):
    """The kernel's queries (f32 for a float corpus; for a quantized one
    rounded to bf16 once, as the reference does, for the tensor cores),
    format code and scales (pq4: the kernels' copy of the level table,
    :func:`_pq_kernel_table`). The kernels copy the queries 16 bytes at a
    time."""
    dtype = torch.float32 if quant == "none" else torch.bfloat16
    q = queries.to(dtype).contiguous()
    q = q if q.data_ptr() % 16 == 0 else q.clone()
    if quant == "pq4":
        m = 2 * corpus.shape[1]
        ds = scales.shape[1] // m
        return q, _KIND[quant] + ds.bit_length() - 1, _pq_kernel_table(scales, m)
    return q, _KIND[corpus.dtype if quant == "none" else quant], scales


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


def _probe_rows(codes: torch.Tensor, scales: torch.Tensor, quant: str):
    """A probe's codes and scales as one corpus of T * 32 rows (pq4's level
    table belongs to every tile and stays whole)."""
    rows = codes.reshape(codes.shape[0] * 32, -1)
    if quant == "pq4":
        return rows, scales
    return rows, scales.reshape(rows.shape[0], *scales.shape[2:])


def score_probe(codes: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                quant: str) -> torch.Tensor:
    """The mma order alone, for the card's tests of it (``csrc/gather_groups.cu``'s
    ``score_probe_kernel``, int8/int4, and ``pq_probe_kernel``, pq4: one warp
    a tile, the sweeps' slot routines ``mma_slot_fold`` and ``pq_slot``).

    ``codes`` [T, 32, *] in ``quant``'s format ("int8", "int4" or "pq4") with
    ``scales`` [T, 32] or [T, 32, D/128] (pq4: the [16, D] level table of
    every tile), ``queries`` [T, 8, D] -> f32 [T, 32, 8]: tile t's 32 rows
    (the A operand's two m16 tiles) against its 8 queries (one n8 tile), so a
    test can put one (row, query) pair at every place of the fragments. A
    diagnostic on no search path: it counts no launch. On CPU tensors it
    runs :func:`score_probe_plain`.
    """
    if quant not in ("int8", "int4", "pq4") or codes.dim() != 3 or codes.shape[1] != 32:
        raise ValueError(f"score_probe takes int8, int4 or pq4 codes [T, 32, *], got {quant} "
                         f"{tuple(codes.shape)}")
    tiles = codes.shape[0]
    d = queries.shape[-1]
    rows, rscales = _probe_rows(codes, scales, quant)
    check_corpus(rows, rscales, quant)
    if tuple(queries.shape) != (tiles, 8, d) or _corpus_dim(rows, rscales, quant) != d:
        raise ValueError(f"queries {tuple(queries.shape)} do not match codes "
                         f"{tuple(codes.shape)}")
    if on_cpu(codes, scales, queries):
        return score_probe_plain(codes, scales, queries, quant)
    _check_kernel_operands(rows, rscales, quant)
    lib = load_library()
    q, kind, operand = _kernel_args(queries.reshape(tiles * 8, d), rows, scales, quant)
    out = torch.empty((tiles, 32, 8), dtype=torch.float32, device=codes.device)
    with torch.cuda.device(codes.device):
        err = lib.kirag_score_probe(codes.data_ptr(), kind, operand.data_ptr(), q.data_ptr(),
                                    out.data_ptr(), tiles, d,
                                    torch.cuda.current_stream(codes.device).cuda_stream)
    raise_on(err, lib, "score_probe")
    return out


def score_probe_plain(codes: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
                      quant: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_probe`: :func:`quant_scores`
    of each tile."""
    return torch.stack([quant_scores(queries[t], codes[t],
                                     scales if quant == "pq4" else scales[t], quant).T
                        for t in range(codes.shape[0])])


# ------------------------------------------------------------- search_plan
#
# How a K1, K5 or K7a call is cut (csrc/score.cuh's sweep_passes:
# score_passes for float rows, mma_passes for int8 and int4, pq_passes for
# pq4). K5 is cut as one chunk of all the corpus's groups, as K7a with no
# store.

SMS = 132                  # the H100's streaming multiprocessors
BLOCKS_PER_SM = 2          # score.cuh's SWEEP_BLOCKS_PER_SM; K1's bf16 32-query sweep
                           # runs 1, where half the ranges time the same (PERF.md §6)
PQ_TWO_BLOCKS_MAX_QT = 8   # score.cuh's: pq4 sweeps run two blocks an SM up to this
                           # query tile (where two blocks' shared memory fits), else one
SMEM_PER_SM = 233472       # 228 KB of shared memory an SM,
SMEM_PER_BLOCK = 232448    # 227 KB of it at most a block,
SMEM_RESERVED = 1024       # and 1 KB the hardware keeps per block
QUERY_TILES = (4, 8, 16, 32)  # queries a block: 4 J, J queries a thread
PASS_ROWS = 256            # corpus rows a pass: two groups
ROW_BYTES = 128            # bytes of each row a ring slot holds (32 f32, 64 bf16 columns;
                           # 128 int8 dims, or 128 dims of each int4 plane)
MMA_SLOT_DIMS = 128        # int8/int4: the bf16 query dims of a slot (score.cuh)
PQ_Q_PAD = 16              # pq4: bf16 padding of a query row in the block's tile
STAGES = 2                 # ring slots (score.cuh's SWEEP_STAGES)
FILL = 0.9                 # the share of the last wave of blocks the cut fills
MAX_SCRATCH = 8            # K1's scratch holds at most 8x the capture's groups,
MAX_HELD_SMEM = 64 * 1024  # and a block tracks its best groups in at most 64 KB


def pq_stage_bytes(q_tile: int) -> int:
    """score.cuh's sweep_stage_bytes for pq4: 128 bytes of each pass row,
    or the transpose of the tile's scores where that is more."""
    return max(PASS_ROWS * ROW_BYTES, PASS_ROWS * (q_tile + 1) * 4)


def sweep_blocks_per_sm(q_tile: int, smem: int, pq: Optional[Tuple[int, int]] = None) -> int:
    """Blocks an SM of a sweep of ``q_tile`` queries and ``smem`` bytes of
    shared memory: BLOCKS_PER_SM; for pq4 two up to PQ_TWO_BLOCKS_MAX_QT
    queries where two blocks' shared memory fits an SM, else one."""
    if pq is None:
        return BLOCKS_PER_SM
    two = q_tile <= PQ_TWO_BLOCKS_MAX_QT and 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    return 2 if two else 1


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """The cut of one K1, K5 or K7a call, passed whole to the kernel,
    which refuses a cut that does not cover its call: ``q_tiles`` tiles of
    ``q_tile`` queries times, for each chunk, ``splits`` ranges of
    ``groups_per_block`` groups (the last may hold fewer), one block each. K1
    keeps ``slots`` = min(b, groups_per_block) groups per (range, query) in
    its scratch (``slots == 0`` for K5 and K7a); ``smem`` is a sweep block's shared
    memory (the kernel refuses a figure other than its own), ``blocks`` the
    grid."""

    q_tile: int
    q_tiles: int
    splits: int
    groups_per_block: int
    slots: int
    smem: int
    blocks: int

    @property
    def tracks_best(self) -> bool:
        """True when a range holds more groups than slots, so a group takes
        a slot only by beating the worst one held."""
        return 0 < self.slots < self.groups_per_block


def _sweep_smem(elem_bytes: int, q_tile: int, b: int, slots: int, gpb: int,
                pq: Optional[Tuple[int, int]] = None) -> int:
    """The shared memory of one sweep block (capture_sweep_kernel with b > 0,
    score_sweep_kernel and group_max_sweep_kernel with b == 0: the ring
    alone, since K5 peels in registers; score.cuh's sweep_ring_bytes).
    ``elem_bytes`` 1 is an int8 or packed-int4 corpus: a slot's queries are
    bf16, whole n8 tiles of them, for both int4 planes at a tile of one n8
    tile (score.cuh's mma_stage_bytes); with ``pq`` = (D, m) a pq4 corpus: a
    slot holds the codes alone (:func:`pq_stage_bytes`), the level table lies
    ahead of the ring and the query tile's whole n8 tiles of bf16 rows (D +
    PQ_Q_PAD a row) behind it."""
    q_rows = -(-q_tile // 8) * 8
    if pq is not None:
        smem = (pq_table_bytes(*pq) + STAGES * pq_stage_bytes(q_tile)
                + q_rows * (pq[0] + PQ_Q_PAD) * 2)
    elif elem_bytes == 1:
        planes = 2 if q_tile <= 8 else 1
        smem = STAGES * (PASS_ROWS * (ROW_BYTES + 16)
                         + planes * q_rows * (MMA_SLOT_DIMS + 16) * 2)
    else:
        cols = ROW_BYTES // elem_bytes                    # score.cuh's sweep_cols
        smem = STAGES * (PASS_ROWS * (ROW_BYTES + 16) + q_tile * (cols + 4) * 4)
    if b:
        smem += 4 * 4 * q_tile                           # the pass's maxima and slots
        if slots < gpb:
            smem += 8 * q_tile * slots + 4 * q_tile      # held maxima and ids, worst slot
    return smem


@functools.lru_cache(maxsize=4096)
def search_plan(n_q: int, num_chunks: int, groups_per_chunk: int, elem_bytes: int,
                b: int = 0, pq: Optional[Tuple[int, int]] = None) -> SearchPlan:
    """The cut of a float32 (``elem_bytes`` 4), bfloat16 (2), int8 or
    packed-int4 (1) K1 call with capture budget ``b``, or K7a or K5 call
    (``b`` 0; K5 one chunk), over ``num_chunks`` chunks of
    ``groups_per_chunk`` groups and ``n_q`` queries; ``pq`` = (D, m) for a
    pq4 corpus (``elem_bytes`` 1).

    The query tile is the smallest of 4, 8, 16, 32 that holds the queries
    (32 beyond), halved while even one group a block would leave SMs idle
    (pq4: also while its block's shared memory passes ``SMEM_PER_BLOCK``).
    The chunk's groups are then split over 1, 2, 4, ... ranges until the
    blocks fill ``FILL`` of their last wave (``SMS`` times
    :func:`sweep_blocks_per_sm` blocks a wave) or a range is one group, unless K1's
    scratch would pass ``MAX_SCRATCH`` times its capture; K1 splits further
    where tracking a range's best groups would take more than
    ``MAX_HELD_SMEM``, or (pq4) a block more than ``SMEM_PER_BLOCK``."""
    g = groups_per_chunk
    if (n_q < 1 or num_chunks < 1 or g < 1 or elem_bytes not in (1, 2, 4) or not 0 <= b <= g
            or (pq is not None and (elem_bytes != 1 or pq_kernel_geometry_error(*pq)))):
        raise ValueError(f"no search plan for Q={n_q}, {num_chunks} chunks of {g} groups, "
                         f"{elem_bytes}-byte rows, b={b}, pq={pq}")
    q_tile = next((t for t in QUERY_TILES if t >= n_q), QUERY_TILES[-1])
    while q_tile > QUERY_TILES[0] and -(-n_q // q_tile) * num_chunks * g < SMS:
        q_tile //= 2
    while (pq is not None and q_tile > QUERY_TILES[0]
           and _sweep_smem(1, q_tile, b, 0, 0, pq) > SMEM_PER_BLOCK):
        q_tile //= 2
    q_tiles = -(-n_q // q_tile)
    wave = SMS * sweep_blocks_per_sm(q_tile, _sweep_smem(1, q_tile, b, 0, 0, pq), pq)

    def cut(s: int):
        gpb = -(-g // s)
        return -(-g // gpb), gpb, (min(b, gpb) if b else 0)

    def filled(blocks: int) -> float:
        return blocks / (-(-blocks // wave) * wave)

    splits, gpb, slots = cut(1)
    while gpb > 1 and filled(q_tiles * num_chunks * splits) < FILL:
        nxt = cut(2 * splits)
        if b and nxt[0] * nxt[2] > MAX_SCRATCH * b:
            break
        splits, gpb, slots = nxt
    while b and slots < gpb and (8 * q_tile * slots > MAX_HELD_SMEM or _sweep_smem(
            elem_bytes, q_tile, b, slots, gpb, pq) > SMEM_PER_BLOCK):
        splits, gpb, slots = cut(2 * splits)
    return SearchPlan(q_tile, q_tiles, splits, gpb, slots,
                      _sweep_smem(elem_bytes, q_tile, b, slots, gpb, pq),
                      q_tiles * num_chunks * splits)


def corpus_plan(n_q: int, num_chunks: int, groups: int, corpus: torch.Tensor,
                scales: Optional[torch.Tensor], quant: str, b: int = 0) -> SearchPlan:
    """search_plan's cut of a K1 (b > 0) or K7a call over ``corpus`` stored
    in ``quant``'s format."""
    pq = (scales.shape[1], 2 * corpus.shape[1]) if quant == "pq4" else None
    return search_plan(n_q, num_chunks, groups, corpus.element_size(), b, pq)


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
    # search_plan's cut; the capture is copied from the ranges' scratch
    p = corpus_plan(n_q, num_chunks, groups_per_chunk, corpus, scales, quant, b)
    scratch = torch.empty((num_chunks * p.splits, n_q, p.slots, LANES), dtype=torch.float32,
                          device=dev)
    held = None
    if p.tracks_best:
        held = torch.empty((num_chunks * p.splits, n_q, p.slots), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kirag_stream_capture(
            q.data_ptr(), corpus.data_ptr(), kind, _ptr(operand),
            gmax.data_ptr(), capture.data_ptr(), gids.data_ptr(), capmax.data_ptr(),
            resid.data_ptr(), scratch.data_ptr(), _ptr(held), n_q, d, num_chunks, chunk_size, b,
            int(valid_rows), p.q_tile, p.splits, p.groups_per_block, p.slots, p.smem,
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
    dtype = str(corpus.dtype)[6:] if quant == "none" else quant
    count_launch(_launch_name("gather_groups", quant),
                 f"{dtype} Q={n_q} k={k} groups={corpus.shape[0] // LANES}")
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


# ---------------------------------------------------------------- score_gmax

# score_gmax's store layouts: chunk-major [C, Q, chunk] (impl="single"),
# row-major [Q, N] (impl="single_strided"), or none (impl="twopass")
SCORE_STORES = ("chunk", "row", "none")


def _score_geometry(queries, corpus, scales, quant: str, chunk_size: int, store: str):
    if store not in SCORE_STORES:
        raise ValueError(f"store must be one of {SCORE_STORES}, got {store!r}")
    return _capture_geometry(queries, corpus, scales, quant, chunk_size, 1)


def score_gmax(queries: torch.Tensor, corpus: torch.Tensor, valid_rows: int,
               chunk_size: int, store: str = "chunk", scales: Optional[torch.Tensor] = None,
               quant: str = "none") -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Every score and the 128-row group maxima (K7a).

    ``corpus`` [C * chunk_size, *] in ``quant``'s format, ``queries`` [Q, D].
    Returns ``(scores, gmax [C, G, Q] f32)``: the outputs of
    ``kirag_tpu.ops.pallas_exact._score_gmax_kernel``. ``scores`` are raw f32
    scores laid out by ``store``: "chunk" [C, Q, chunk_size], "row"
    [Q, C * chunk_size], or None for "none". In the maxima, rows at or past
    ``valid_rows`` count as FIN_MIN (not clamped: unlike K1's, a -inf score
    stays -inf). The scores and maxima are bitwise K1's and K2's on the same
    rows (one scoring routine, ``csrc/score.cuh``).
    """
    num_chunks, groups_per_chunk = _score_geometry(queries, corpus, scales, quant,
                                                   chunk_size, store)
    if on_cpu(queries, *_tensors(corpus, scales)):
        return score_gmax_plain(queries, corpus, valid_rows, chunk_size, store, scales, quant)
    _check_kernel_operands(corpus, scales, quant)
    lib = load_library()
    n_q, d = queries.shape
    n = corpus.shape[0]
    q, kind, operand = _kernel_args(queries, corpus, scales, quant)
    dev = corpus.device
    gmax = torch.empty((num_chunks, groups_per_chunk, n_q), dtype=torch.float32, device=dev)
    scores, s_chunk, s_q = None, 0, 0
    if store == "chunk":
        scores = torch.empty((num_chunks, n_q, chunk_size), dtype=torch.float32, device=dev)
        s_chunk, s_q = n_q * chunk_size, chunk_size
    elif store == "row":
        scores = torch.empty((n_q, n), dtype=torch.float32, device=dev)
        s_chunk, s_q = chunk_size, n
    p = corpus_plan(n_q, num_chunks, groups_per_chunk, corpus, scales, quant)
    with torch.cuda.device(dev):
        err = lib.kirag_score_gmax(
            q.data_ptr(), corpus.data_ptr(), kind, _ptr(operand), _ptr(scores),
            gmax.data_ptr(), n_q, d, num_chunks, chunk_size, int(valid_rows), s_chunk, s_q,
            p.q_tile, p.splits, p.groups_per_block, p.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib, "score_gmax")
    count_launch(_launch_name("score_gmax", quant))
    return scores, gmax


def score_gmax_plain(queries: torch.Tensor, corpus: torch.Tensor, valid_rows: int,
                     chunk_size: int, store: str = "chunk",
                     scales: Optional[torch.Tensor] = None,
                     quant: str = "none") -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of :func:`score_gmax`, same contract."""
    num_chunks, groups_per_chunk = _score_geometry(queries, corpus, scales, quant,
                                                   chunk_size, store)
    n_q = queries.shape[0]
    dev = corpus.device
    gmax = torch.empty((num_chunks, groups_per_chunk, n_q), dtype=torch.float32, device=dev)
    chunks = []
    for c in range(num_chunks):
        rows = slice(c * chunk_size, (c + 1) * chunk_size)
        s = quant_scores(queries, corpus[rows], row_scales(scales, rows, quant), quant)
        row = torch.arange(rows.start, rows.stop, device=dev)
        masked = torch.where(row < valid_rows, s, FIN_MIN)
        gmax[c] = masked.view(n_q, groups_per_chunk, LANES).amax(-1).T
        if store != "none":
            chunks.append(s)
    if store == "chunk":
        return torch.stack(chunks), gmax
    if store == "row":
        return torch.cat(chunks, dim=1), gmax
    return None, gmax


# ------------------------------------------------ score_gather, cap_assemble


def _check_copy(src: torch.Tensor, idx: torch.Tensor, per: int, what: str) -> None:
    if src.dim() != 3 or src.dtype != torch.float32 or not src.is_contiguous():
        raise ValueError(f"{what}: the source must be a contiguous f32 [C, Q, X * 128] "
                         f"tensor, got {tuple(src.shape)} {src.dtype}")
    if per < 1 or src.shape[2] != per * LANES:
        raise ValueError(f"{what}: source rows of {src.shape[2]} scores are not {per} "
                         f"groups of {LANES}")
    if idx.dim() != 2 or idx.shape[0] != src.shape[1] or idx.shape[1] < 1:
        raise ValueError(f"{what}: indices {tuple(idx.shape)} must be [Q, k] for "
                         f"{src.shape[1]} queries")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: indices must be int32 or int64, got {idx.dtype}")


COPY_WARPS_PER_BLOCK = (8, 4, 2, 1)  # csrc/copy_groups.cu takes at most the first


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """The cut of one K7b or K8 call: one (query, slot) pair a warp,
    ``warps_per_block`` warps a block, ``blocks`` blocks. The kernel refuses
    a cut that does not cover the call's Q * k pairs with every block
    holding at least one."""

    warps_per_block: int
    blocks: int


@functools.lru_cache(maxsize=4096)
def copy_plan(n_q: int, k: int, sm_count: int = SMS) -> CopyPlan:
    """The cut of a copy of ``n_q * k`` groups: the most warps a block of
    :data:`COPY_WARPS_PER_BLOCK` that still give every SM a block, else
    one."""
    if n_q < 1 or k < 1 or sm_count < 1:
        raise ValueError(f"no copy plan for Q={n_q}, k={k}, {sm_count} SMs")
    pairs = n_q * k
    wpb = next((w for w in COPY_WARPS_PER_BLOCK if -(-pairs // w) >= sm_count), 1)
    return CopyPlan(wpb, -(-pairs // wpb))


def _copy_groups(src: torch.Tensor, idx: torch.Tensor, per: int, name: str,
                 entry: str) -> torch.Tensor:
    """Launch csrc/copy_groups.cu: ``out[q, j] = src[idx // per, q, idx % per]``
    as 128-score groups; zeros for an index outside [0, C * per). The int32
    or int64 indices are read where they lie, at their own strides: no cast,
    no copy."""
    lib = load_library()
    n_q, k = idx.shape
    if src.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads the source 16 bytes at a time; "
                         "it must be 16-byte aligned")
    p = copy_plan(n_q, k)
    out = torch.empty((n_q, k, LANES), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        err = getattr(lib, entry)(src.data_ptr(), idx.data_ptr(), idx.element_size(),
                                  *idx.stride(), out.data_ptr(), src.shape[0], n_q, k, per,
                                  p.warps_per_block, p.blocks,
                                  torch.cuda.current_stream(src.device).cuda_stream)
    raise_on(err, lib, name)
    count_launch(name)
    return out


def _copy_groups_plain(src: torch.Tensor, idx: torch.Tensor, per: int) -> torch.Tensor:
    n_c, n_q, _ = src.shape
    idx = idx.long()
    inside = (idx >= 0) & (idx < n_c * per)
    safe = torch.where(inside, idx, 0)
    qrow = torch.arange(n_q, device=src.device)[:, None]
    out = src.view(n_c, n_q, per, LANES)[safe // per, qrow, safe % per]
    return torch.where(inside[..., None], out, 0.0)


def score_gather(scores: torch.Tensor, gsel: torch.Tensor) -> torch.Tensor:
    """Each query's selected groups out of K7a's chunk-major scores (K7b).

    ``scores`` [C, Q, chunk] f32, ``gsel`` [Q, k] group ids -> ``cand``
    [Q, k, 128] f32 with ``cand[q, j] = scores[g // G, q, (g % G) * 128 :
    + 128]`` for ``g = gsel[q, j]``, G = chunk / 128: a copy (bitwise), the
    function of ``kirag_tpu.ops.pallas_exact._score_gather_kernel``; a group
    id outside the corpus gives zeros, as its one-hot accumulation does.
    """
    per = scores.shape[2] // LANES if scores.dim() == 3 else 0
    _check_copy(scores, gsel, per, "score_gather")
    if on_cpu(scores, gsel):
        return score_gather_plain(scores, gsel)
    return _copy_groups(scores, gsel, per, "score_gather", "kirag_score_gather")


def score_gather_plain(scores: torch.Tensor, gsel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_gather`, same contract."""
    per = scores.shape[2] // LANES if scores.dim() == 3 else 0
    _check_copy(scores, gsel, per, "score_gather")
    return _copy_groups_plain(scores, gsel, per)


def cap_assemble(cpos: torch.Tensor, capture: torch.Tensor, b: int) -> torch.Tensor:
    """The selected capture positions copied out of K1's capture (K8).

    ``cpos`` [Q, k] positions in the flattened [C, b] capture order,
    ``capture`` [C, Q, b * 128] f32 -> [Q, k, 128] f32 with row ``(q, j)``
    the 128 scores of capture slot ``cpos % b`` of chunk ``cpos // b``: a
    copy (bitwise), the function of
    ``kirag_tpu.ops.pallas_exact._cap_assemble_kernel``.
    """
    _check_copy(capture, cpos, b, "cap_assemble")
    if on_cpu(cpos, capture):
        return cap_assemble_plain(cpos, capture, b)
    return _copy_groups(capture, cpos, b, "cap_assemble", "kirag_cap_assemble")


def cap_assemble_plain(cpos: torch.Tensor, capture: torch.Tensor, b: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`cap_assemble`, same contract."""
    _check_copy(capture, cpos, b, "cap_assemble")
    return _copy_groups_plain(capture, cpos, b)


# -------------------------------------------------------------- window_merge


MAX_MERGE_SMEM = 232448    # csrc/window_merge.cu's MAX_SMEM: a block's shared memory
MERGE_MAX_SEGMENTS = 32    # its MAX_SEGMENTS: a warp a segment, one block a query
MERGE_LANE_BC = 32         # its MAX_LANE_BC: above this capture budget, the reference's steps


def merge_smem_bytes(br: int, bc: int, segments: int) -> int:
    """csrc/window_merge.cu's ``smem_bytes``: the block's head, the final
    order's positions, and each warp's two window lists (16 bytes an item)
    and a step's winners (or, if larger, the reference's slots)."""
    region = max(segments * (32 * br + 640), 4 * (3 * br + 8 * bc))
    return 4 * (4 + MERGE_MAX_SEGMENTS) + -(-4 * br // 16) * 16 + region


def merge_segments(n_c: int, bc: int, br: int, n_q: int = 1) -> int:
    """K9's segments (warps) a query: one a chunk after the first, up to 32
    and as many as shared memory holds (each warp sweeps its chunks twice;
    composing the segments' windows takes log2 S merges); at most 16 when
    the queries' blocks outnumber the SMs, so that two blocks share an SM;
    1 when ``bc`` is above 32 (the kernel then runs the reference's steps).
    PERF.md §6 has the times behind the rule."""
    if bc > MERGE_LANE_BC:
        return 1
    s = min(MERGE_MAX_SEGMENTS if n_q <= SMS else MERGE_MAX_SEGMENTS // 2, max(1, n_c - 1))
    while s > 1 and merge_smem_bytes(br, bc, s) > MAX_MERGE_SMEM:
        s -= 1
    return s


def _check_merge(gids, capmax, resid, capture, br: int, total_groups: int):
    if capmax.dim() != 3 or capmax.dtype != torch.float32:
        raise ValueError(f"capmax must be f32 [C, bc, Q], got {tuple(capmax.shape)}")
    n_c, bc, n_q = capmax.shape
    if (tuple(gids.shape) != (n_c, bc, n_q) or gids.dtype != torch.int32
            or tuple(resid.shape) != (n_c, 1, n_q) or resid.dtype != torch.float32
            or tuple(capture.shape) != (n_c, n_q, bc * LANES)
            or capture.dtype != torch.float32):
        raise ValueError("window_merge takes K1's gids [C, bc, Q] int32, capmax [C, bc, Q], "
                         f"resid [C, 1, Q] and capture [C, Q, bc * 128] f32; got "
                         f"{tuple(gids.shape)}, {tuple(capmax.shape)}, {tuple(resid.shape)}, "
                         f"{tuple(capture.shape)}")
    if not all(t.is_contiguous() for t in (gids, capmax, resid, capture)):
        raise ValueError("window_merge's inputs must be contiguous")
    if br < bc:
        raise ValueError(f"window width {br} below the capture budget {bc}")
    if total_groups < 1 or total_groups + br >= 2 ** 31:
        raise ValueError(f"total_groups {total_groups} out of range")
    return n_c, bc, n_q


def _check_segments(segments: int, n_c: int, bc: int) -> None:
    top = 1 if bc > MERGE_LANE_BC else min(MERGE_MAX_SEGMENTS, max(1, n_c - 1))
    if not 1 <= segments <= top:
        raise ValueError(f"{segments} segments: the kernel takes 1..{top} at C={n_c}, bc={bc}")


def window_merge(gids: torch.Tensor, capmax: torch.Tensor, resid: torch.Tensor,
                 capture: torch.Tensor, br: int, total_groups: int,
                 segments: Optional[int] = None,
                 paths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The running top-``br`` group window of ``select="merge"`` (K9).

    Takes K1's capdom outputs (``gids``, ``capmax`` [C, bc, Q], ``resid``
    [C, 1, Q], ``capture`` [C, Q, bc * 128]), which are per chunk what
    ``kirag_tpu.ops.pallas_exact._merge_kernel`` peels, and computes that
    kernel's chunk-by-chunk merge: chunk 0 fills slots 0..bc-1 (the rest
    empty: key -inf, gid -(slot + 1)); each later chunk peels the window's bc
    worst slots (ascending key, ties to the lower slot), ranks the 2 * bc
    union by (key desc, gid asc), and writes the j-th surviving new group
    into the j-th ejected slot. Returns ``(win [Q, br, 128] f32, wkey [Q, br]
    f32, wgid [Q, br] int32, lost [C, 1, Q] f32)``: the window sorted by gid
    ascending, empty slots given the gid ``total_groups + slot`` and zero
    scores, keys clamped to FIN_MIN; ``lost[c]`` the larger of chunk c's
    residual and the best key the merge ejected (chunk 0: its residual).

    The kernel splits the chunks into ``segments`` (default
    :func:`merge_segments`) whose windows compose (csrc/window_merge.cu);
    the result does not depend on the count. ``paths``, an int32 [Q] tensor
    on the card, receives 1 for each query that took the reference's steps
    (a tie the segments cannot settle, or bc above 32) and 0 for the others.
    """
    n_c, bc, n_q = _check_merge(gids, capmax, resid, capture, br, total_groups)
    if segments is not None:
        _check_segments(segments, n_c, bc)
    if paths is not None and (paths.shape != (n_q,) or paths.dtype != torch.int32
                              or paths.device != capmax.device or not paths.is_contiguous()):
        raise ValueError(f"paths must be int32 [{n_q}] beside the inputs")
    if on_cpu(gids, capmax, resid, capture):
        if paths is not None:
            raise ValueError("paths reports the kernel's forms; the plain version has one")
        return window_merge_plain(gids, capmax, resid, capture, br, total_groups)
    if segments is None:
        segments = merge_segments(n_c, bc, br, n_q)
    if merge_smem_bytes(br, bc, segments) > MAX_MERGE_SMEM:
        raise ValueError(f"the window of br={br} groups (capture budget {bc}) in {segments} "
                         f"segments does not fit the kernel's {MAX_MERGE_SMEM} bytes of shared "
                         "memory")
    lib = load_library()
    dev = capmax.device
    win = torch.empty((n_q, br, LANES), dtype=torch.float32, device=dev)
    wkey = torch.empty((n_q, br), dtype=torch.float32, device=dev)
    wgid = torch.empty((n_q, br), dtype=torch.int32, device=dev)
    lost = torch.empty((n_c, 1, n_q), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kirag_window_merge(
            gids.data_ptr(), capmax.data_ptr(), resid.data_ptr(), capture.data_ptr(),
            win.data_ptr(), wkey.data_ptr(), wgid.data_ptr(), lost.data_ptr(),
            n_c, bc, n_q, br, total_groups, segments, _ptr(paths),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib, "window_merge")
    count_launch("window_merge")
    return win, wkey, wgid, lost


def _peel_worst(x: torch.Tensor, b: int) -> torch.Tensor:
    """``_worstb_ids``: the slots of the ``b`` smallest values of ``x``
    [Q, S] by b masked-min extractions (ties to the lowest slot), in
    extraction order."""
    n_q, s = x.shape
    x = x.clone()
    col = torch.arange(s, device=x.device).expand(n_q, s)
    picks = []
    for _ in range(b):
        m = x.amin(-1, keepdim=True)
        pick = torch.where(x == m, col, s).amin(-1, keepdim=True)
        picks.append(pick)
        x.scatter_(1, pick, float("inf"))
    return torch.cat(picks, dim=1)


def window_merge_plain(gids: torch.Tensor, capmax: torch.Tensor, resid: torch.Tensor,
                       capture: torch.Tensor, br: int, total_groups: int
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`window_merge`, same contract: the
    reference kernel's steps, one chunk at a time, for all queries at once."""
    n_c, bc, n_q = _check_merge(gids, capmax, resid, capture, br, total_groups)
    dev = capmax.device
    slot = torch.arange(br, device=dev).expand(n_q, br)
    wkey = torch.full((n_q, br), float("-inf"), device=dev)
    wgid = -(slot + 1)
    wpos = torch.full((n_q, br), -1, dtype=torch.int64, device=dev)  # [C, bc] capture position
    wkey[:, :bc] = capmax[0].T
    wgid[:, :bc] = gids[0].T.long()
    wpos[:, :bc] = torch.arange(bc, device=dev)
    lost = torch.empty((n_c, 1, n_q), dtype=torch.float32, device=dev)
    lost[0] = resid[0]
    tri = torch.tril(torch.ones(bc, bc, dtype=torch.int64, device=dev))
    for c in range(1, n_c):
        bvals, ngid = capmax[c].T, gids[c].T.long()                  # [Q, bc]
        npos = c * bc + torch.arange(bc, device=dev).expand(n_q, bc)
        peel = _peel_worst(wkey, bc)                                 # [Q, bc]
        v = torch.cat([torch.gather(wkey, 1, peel), bvals], dim=1)   # [Q, 2bc]
        g = torch.cat([torch.gather(wgid, 1, peel), ngid], dim=1)
        beats = (v[:, :, None] > v[:, None, :]) | (
            (v[:, :, None] == v[:, None, :]) & (g[:, :, None] < g[:, None, :]))
        survive = beats.sum(1) < bc                                  # the top bc of 2bc
        ej_old, sv_new = ~survive[:, :bc], survive[:, bc:]
        # the j-th ejected slot takes the j-th surviving new group
        orde = (ej_old.long()[:, None, :] * tri).sum(-1)             # inclusive counts
        ords = (sv_new.long()[:, None, :] * tri).sum(-1)
        assign = ej_old[:, :, None] & sv_new[:, None, :] & (orde[:, :, None] == ords[:, None, :])
        pick = assign.long().argmax(-1)                              # [Q, bc]
        taken = assign.any(-1)
        for arr, new in ((wkey, bvals), (wgid, ngid), (wpos, npos)):
            arr.scatter_(1, peel, torch.where(taken, torch.gather(new, 1, pick),
                                              torch.gather(arr, 1, peel)))
        ej = torch.where(survive, float("-inf"), v).amax(-1)
        lost[c, 0] = torch.maximum(resid[c, 0], ej)
    keys = wkey.clamp_min(FIN_MIN)
    sg = torch.where(wgid < 0, total_groups + slot, wgid)
    order = torch.argsort(sg, dim=1)                                 # gids are unique
    pos = torch.gather(wpos, 1, order)
    safe = pos.clamp_min(0)
    qrow = torch.arange(n_q, device=dev)[:, None]
    win = capture.view(n_c, n_q, bc, LANES)[safe // bc, qrow, safe % bc]
    win = torch.where((pos >= 0)[..., None], win, 0.0)
    return (win, torch.gather(keys, 1, order), torch.gather(sg, 1, order).to(torch.int32),
            lost)
