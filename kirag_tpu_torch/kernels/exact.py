"""Wrappers of the exact-search kernels, each beside its plain version.

``stream_capture`` (K1, ``csrc/stream_capture.cu``) and ``gather_groups``
(K2, ``csrc/gather_groups.cu``) take tensors on one device. On a CUDA tensor
a wrapper launches its kernel or raises; on a CPU tensor it runs its plain
PyTorch version, which computes the same function with f32 products and f32
sums (a CUDA kernel cannot run on the CPU). Each launch adds one to the
wrapper's count in :func:`~kirag_tpu_torch.kernels.common.launch_counts`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kirag_tpu_torch.kernels.build import load_library
from kirag_tpu_torch.kernels.common import count_launch, on_cpu, raise_on

LANES = 128
FIN_MIN = -1e30


def _check_corpus(corpus: torch.Tensor) -> None:
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corpus must be float32 or bfloat16, got {corpus.dtype}")
    if corpus.dim() != 2 or not corpus.is_contiguous():
        raise ValueError("corpus must be a contiguous [N, D] matrix")


def _check_kernel_operands(corpus) -> None:
    """What the CUDA kernels take beyond the plain versions: 16-byte vector
    reads of the corpus rows."""
    if corpus.shape[1] % 8 or corpus.data_ptr() % 16:
        raise ValueError(f"the CUDA kernels need D % 8 == 0 and a 16-byte aligned "
                         f"corpus, got D={corpus.shape[1]}")


# ------------------------------------------------------------ stream_capture


def _capture_geometry(queries, corpus, chunk_size: int, b: int):
    _check_corpus(corpus)
    if queries.dim() != 2 or queries.shape[1] != corpus.shape[1] or queries.shape[0] < 1:
        raise ValueError(f"queries {tuple(queries.shape)} do not match corpus "
                         f"{tuple(corpus.shape)}")
    n = corpus.shape[0]
    if chunk_size % LANES or chunk_size <= 0 or n % chunk_size or n == 0:
        raise ValueError(f"corpus rows {n} must be a positive multiple of "
                         f"chunk_size {chunk_size}, itself a multiple of {LANES}")
    groups_per_chunk = chunk_size // LANES
    if not 1 <= b <= groups_per_chunk:
        raise ValueError(f"capture budget {b} outside [1, {groups_per_chunk}]")
    return n // chunk_size, groups_per_chunk


def stream_capture(queries: torch.Tensor, corpus: torch.Tensor, valid_rows: int,
                   chunk_size: int, b: int) -> Tuple[torch.Tensor, ...]:
    """Per-chunk group maxima and top-``b`` group capture (K1).

    ``corpus`` [C * chunk_size, D] f32 or bf16, ``queries`` [Q, D]. Returns
    ``(gmax [C, G, Q] f32, capture [C, Q, b * 128] f32, gids [C, b, Q] int32,
    capmax [C, b, Q] f32, resid [C, 1, Q] f32)`` with G = chunk_size / 128:
    the outputs of ``kirag_tpu.ops.pallas_exact._stream_kernel`` under
    ``capdom``. Rows at or past ``valid_rows`` count as FIN_MIN in the maxima;
    captured scores stay raw.
    """
    num_chunks, groups_per_chunk = _capture_geometry(queries, corpus, chunk_size, b)
    if on_cpu(queries, corpus):
        return stream_capture_plain(queries, corpus, valid_rows, chunk_size, b)
    _check_kernel_operands(corpus)
    lib = load_library()
    n_q, d = queries.shape
    q = queries.to(torch.float32).contiguous()
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
            q.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16),
            gmax.data_ptr(), capture.data_ptr(), gids.data_ptr(), capmax.data_ptr(),
            resid.data_ptr(), n_q, d, num_chunks, chunk_size, b, int(valid_rows), qpt,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib, "stream_capture")
    count_launch("stream_capture")
    return gmax, capture, gids, capmax, resid


def stream_capture_plain(queries: torch.Tensor, corpus: torch.Tensor, valid_rows: int,
                         chunk_size: int, b: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`stream_capture`, same contract."""
    num_chunks, groups_per_chunk = _capture_geometry(queries, corpus, chunk_size, b)
    n_q = queries.shape[0]
    dev = corpus.device
    q = queries.to(torch.float32)
    scores = torch.empty((num_chunks, n_q, chunk_size), dtype=torch.float32, device=dev)
    for c in range(num_chunks):
        scores[c] = q @ corpus[c * chunk_size:(c + 1) * chunk_size].to(torch.float32).T
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


def _check_gather(queries, corpus, gsel) -> None:
    _check_corpus(corpus)
    if corpus.shape[0] % LANES:
        raise ValueError(f"corpus rows {corpus.shape[0]} must be a multiple of {LANES}")
    if queries.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} do not match corpus "
                         f"{tuple(corpus.shape)}")
    if gsel.dim() != 2 or gsel.shape[0] != queries.shape[0] or gsel.shape[1] < 1:
        raise ValueError(f"gsel {tuple(gsel.shape)} must be [Q, k] for "
                         f"{queries.shape[0]} queries")
    if gsel.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gsel must be int32 or int64, got {gsel.dtype}")


def gather_groups(queries: torch.Tensor, corpus: torch.Tensor,
                  gsel: torch.Tensor) -> torch.Tensor:
    """Scores of each query's selected 128-row groups (K2).

    ``gsel`` [Q, k] group ids -> ``cand`` [Q, k, 128] f32 with
    ``cand[q, j, l] = queries[q] . corpus[gsel[q, j] * 128 + l]``; a group id
    outside the corpus gives zeros (the reference's one-hot semantics).
    """
    _check_gather(queries, corpus, gsel)
    if on_cpu(queries, corpus, gsel):
        return gather_groups_plain(queries, corpus, gsel)
    _check_kernel_operands(corpus)
    lib = load_library()
    n_q, d = queries.shape
    k = gsel.shape[1]
    q = queries.to(torch.float32).contiguous()
    g32 = gsel.to(torch.int32).contiguous()
    cand = torch.empty((n_q, k, LANES), dtype=torch.float32, device=corpus.device)
    with torch.cuda.device(corpus.device):
        err = lib.kirag_gather_groups(
            q.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16),
            g32.data_ptr(), cand.data_ptr(), n_q, d, k, corpus.shape[0],
            torch.cuda.current_stream(corpus.device).cuda_stream)
    raise_on(err, lib, "gather_groups")
    count_launch("gather_groups")
    return cand


def gather_groups_plain(queries: torch.Tensor, corpus: torch.Tensor,
                        gsel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_groups`, same contract."""
    _check_gather(queries, corpus, gsel)
    n_q, k = gsel.shape
    dev = corpus.device
    inside = (gsel >= 0) & (gsel < corpus.shape[0] // LANES)            # [Q, k]
    rows = gsel.long()[..., None] * LANES + torch.arange(LANES, device=dev)
    rows = torch.where(inside[..., None], rows, 0).reshape(n_q, k * LANES)
    q = queries.to(torch.float32)
    cand = torch.stack([corpus[rows[i]].to(torch.float32) @ q[i] for i in range(n_q)])
    return torch.where(inside[..., None], cand.view(n_q, k, LANES), 0.0)
