"""Wrapper of the approximate search's kernel, beside its plain version.

``group_max`` (K5, ``csrc/group_max.cu``) gives, for each query and each
128-row group of the corpus, the group's ``winners`` best scores and their
lanes: the outputs of ``kirag_tpu.ops.pallas_mips._group_max_kernel``. On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`group_max_plain`. Each launch adds one to its count in
:func:`~kirag_tpu_torch.kernels.common.launch_counts`: ``group_max`` for a
float corpus, ``group_max_int8``/``group_max_int4`` for a quantized one.

The corpus formats and their arithmetic are the exact search's
(:mod:`kirag_tpu_torch.kernels.exact`, :func:`quant_scores`): K5 scores
through the same routine as K1 and K2, so approximate and exact search see
bitwise the same scores. Every format runs K7a's sweep, cut by
:func:`~kirag_tpu_torch.kernels.exact.search_plan` as one chunk of all the
corpus's groups.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kirag_tpu_torch.kernels.build import load_library
from kirag_tpu_torch.kernels.common import count_launch, on_cpu, raise_on
from kirag_tpu_torch.kernels.exact import (
    LANES,
    _check_kernel_operands,
    _corpus_dim,
    _kernel_args,
    _launch_name,
    _ptr,
    _tensors,
    check_corpus,
    quant_scores,
    search_plan,
)

_PLAIN_ROWS = 1 << 16  # corpus rows the plain version scores at a time


def _check_group_max(queries, corpus, winners: int, scales, quant: str) -> None:
    if quant == "pq4":  # the reference serves approximate search on PQ as exact search
        raise ValueError("K5 takes no pq4 corpus: search a PQ index exactly")
    check_corpus(corpus, scales, quant)
    n = corpus.shape[0]
    if n == 0 or n % LANES:
        raise ValueError(f"corpus rows {n} must be a positive multiple of {LANES}")
    if queries.dim() != 2 or queries.shape[1] != _corpus_dim(corpus, scales, quant) or \
            queries.shape[0] < 1:
        raise ValueError(f"queries {tuple(queries.shape)} do not match a {quant} corpus "
                         f"{tuple(corpus.shape)}")
    if not 1 <= winners <= LANES:
        raise ValueError(f"winners must be in [1, {LANES}], got {winners}")


def group_max(queries: torch.Tensor, corpus: torch.Tensor, winners: int = 1,
              scales: Optional[torch.Tensor] = None,
              quant: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Each 128-row group's top-``winners`` scores and lanes (K5).

    ``corpus`` [N, *] in ``quant``'s format, N a multiple of 128; ``queries``
    [Q, D]. Returns ``(gmax [Q, W, N/128] f32, gidx [Q, W, N/128] int32)``:
    per group the W largest scores, descending, and their lanes (row - 128 g),
    equal scores to the lower lane, by W rounds of a masked maximum (the
    reference's peel). Every row is scored, pad rows too. On the card both
    are ``[Q, N/128, W]`` tensors seen through ``transpose(1, 2)`` (a
    group's W winners in consecutive words, so ``transpose(1, 2).reshape(Q,
    -1)`` is a view); on the CPU contiguous.
    """
    _check_group_max(queries, corpus, winners, scales, quant)
    if on_cpu(queries, *_tensors(corpus, scales)):
        return group_max_plain(queries, corpus, winners, scales, quant)
    _check_kernel_operands(corpus, scales, quant)
    lib = load_library()
    n_q, d = queries.shape
    q, kind, operand = _kernel_args(queries, corpus, scales, quant)
    dev = corpus.device
    groups = corpus.shape[0] // LANES
    p = search_plan(n_q, 1, groups, corpus.element_size())  # the sweep's cut of one chunk
    gmax = torch.empty((n_q, groups, winners), dtype=torch.float32, device=dev)
    gidx = torch.empty((n_q, groups, winners), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.kirag_group_max(
            q.data_ptr(), corpus.data_ptr(), kind, _ptr(operand), gmax.data_ptr(),
            gidx.data_ptr(), n_q, d, corpus.shape[0], winners, p.q_tile, p.splits,
            p.groups_per_block, p.smem, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, lib, "group_max")
    count_launch(_launch_name("group_max", quant))
    return gmax.transpose(1, 2), gidx.transpose(1, 2)


def group_max_plain(queries: torch.Tensor, corpus: torch.Tensor, winners: int = 1,
                    scales: Optional[torch.Tensor] = None,
                    quant: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`group_max`, same contract: the scores
    of :func:`quant_scores`, then ``winners`` rounds of the group maximum,
    its lowest lane, and that lane set to -inf."""
    _check_group_max(queries, corpus, winners, scales, quant)
    n_q = queries.shape[0]
    n = corpus.shape[0]
    gmax = torch.empty((n_q, winners, n // LANES), dtype=torch.float32, device=corpus.device)
    gidx = torch.empty((n_q, winners, n // LANES), dtype=torch.int32, device=corpus.device)
    lane = torch.arange(LANES, device=corpus.device)
    for start in range(0, n, _PLAIN_ROWS):
        rows = slice(start, min(start + _PLAIN_ROWS, n))
        s3 = quant_scores(queries, corpus[rows], None if scales is None else scales[rows],
                          quant).view(n_q, -1, LANES)
        groups = slice(start // LANES, start // LANES + s3.shape[1])
        for w in range(winners):
            m = s3.amax(-1)                                                  # [Q, G]
            idx = torch.where(s3 == m[..., None], lane, LANES).amin(-1)
            gmax[:, w, groups], gidx[:, w, groups] = m, idx.to(torch.int32)
            if w + 1 < winners:
                s3 = torch.where(lane == idx[..., None], float("-inf"), s3)
    return gmax, gidx
