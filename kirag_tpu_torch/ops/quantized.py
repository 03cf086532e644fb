"""int8 and packed-int4 compressed corpora (port of
:mod:`kirag_tpu.ops.quantized`).

An int8 corpus keeps one f32 scale per row (values in [-127, 127] x scale);
a packed-int4 corpus keeps two codes per byte, byte j holding dim j in the
low nibble and dim j + D/2 in the high one, and one f32 scale per (row,
128-dim block), value (n - 7.5) x scale. At the DPR corpus's 21,015,324 x
1024 that is 21.5 GB (int8) or 10.8 GB + 0.7 GB of scales (int4) on the
card, where float32 would be 86 GB.

The numpy quantizers are the reference's, byte for byte; the torch ones
quantize a block of rows where it lies (the indexer's ``to_device`` on the
card) and give bitwise the same codes and scales. ``topk_mips_int8`` /
``topk_mips_int4`` are the chunked plain scans the indexer runs on the CPU
and under ``exact_impl="plain"``; the exact kernel search scores such
corpora through K4 (``kirag_tpu_torch.kernels.exact.quant_scores``), whose
int4 arithmetic differs from these scans', as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from kirag_tpu_torch.ops.mips import scan_topk

INT4_BLOCK = 128  # one scale per (row, 128-dim block)


def quantize_rows_int8(embeddings: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: values in [-127, 127] * scale."""
    emb = np.asarray(embeddings, dtype=np.float32)
    absmax = np.abs(emb).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    safe = np.where(scales == 0, 1.0, scales)
    q = np.clip(np.rint(emb / safe[:, None]), -127, 127).astype(np.int8)
    return q, scales


def quantize_rows_int4(embeddings: np.ndarray,
                       block: int = INT4_BLOCK) -> Tuple[np.ndarray, np.ndarray]:
    """Blockwise 4-bit quantization of embedding rows.

    Returns ``(packed uint8 [N, D/2], scales f32 [N, D/block])``. Values map
    to the 16-level grid ``(n - 7.5) * scale`` with ``scale = absmax / 7.5``
    per (row, block). Dim j packs into byte j's low nibble, dim j + D/2 into
    its high nibble.
    """
    emb = np.asarray(embeddings, dtype=np.float32)
    n, d = emb.shape
    assert d % (2 * block) == 0, f"dim {d} must be a multiple of {2 * block}"
    nb = d // block
    blocks = emb.reshape(n, nb, block)
    absmax = np.abs(blocks).max(axis=-1)
    scales = (absmax / 7.5).astype(np.float32)
    safe = np.where(scales == 0, 1.0, scales)
    q = np.clip(np.rint(blocks / safe[:, :, None] + 7.5), 0, 15)
    q = q.astype(np.uint8).reshape(n, d)
    packed = (q[:, :d // 2] | (q[:, d // 2:] << 4)).astype(np.uint8)
    return packed, scales


def dequantize_rows_int4(packed: np.ndarray, scales: np.ndarray,
                         block: int = INT4_BLOCK) -> np.ndarray:
    """Inverse of :func:`quantize_rows_int4` (f32)."""
    packed = np.asarray(packed, dtype=np.uint8)
    n, d2 = packed.shape
    nib = np.concatenate([packed & 15, packed >> 4], axis=1).astype(np.float32)
    nb = 2 * d2 // block
    vals = (nib - 7.5).reshape(n, nb, block) * scales[:, :, None]
    return vals.reshape(n, 2 * d2).astype(np.float32)


def _safe_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded once, as numpy divides: PyTorch's CUDA kernel
    multiplies by the reciprocal of a Python-number divisor, which may be one
    ulp off, so the divisor is passed as a tensor."""
    return x / torch.full((), divisor, dtype=torch.float32, device=x.device)


def quantize_rows_int8_torch(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_int8` on a tensor's device: ``(int8 [N, D],
    scales f32 [N])``, bitwise the numpy result (f32 divisions rounded to
    nearest, ``torch.round`` halves to even as ``np.rint`` does)."""
    emb = rows.to(torch.float32)
    scales = _safe_div(emb.abs().amax(dim=1), 127.0)
    safe = torch.where(scales == 0, 1.0, scales)
    q = torch.round(emb / safe[:, None]).clamp_(-127, 127).to(torch.int8)
    return q, scales


def quantize_rows_int4_torch(rows: torch.Tensor, block: int = INT4_BLOCK
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows_int4` on a tensor's device: ``(packed uint8
    [N, D/2], scales f32 [N, D/block])``, bitwise the numpy result."""
    emb = rows.to(torch.float32)
    n, d = emb.shape
    if d % (2 * block):
        raise ValueError(f"dim {d} must be a multiple of {2 * block}")
    blocks = emb.reshape(n, d // block, block)
    scales = _safe_div(blocks.abs().amax(dim=-1), 7.5)
    safe = torch.where(scales == 0, 1.0, scales)
    q = torch.round(blocks / safe[:, :, None] + 7.5).clamp_(0, 15).to(torch.uint8)
    q = q.view(n, d)
    return q[:, :d // 2] | (q[:, d // 2:] << 4), scales


def topk_mips_int8(queries: torch.Tensor, corpus_i8: torch.Tensor, scales: torch.Tensor,
                   k: int, chunk_size: int = 32768, valid_rows: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked top-k over an int8 corpus with per-row scales: queries
    rounded to bf16, f32 dot products with the codes, times the row scales."""
    q = queries.to(torch.bfloat16).to(torch.float32)
    s = scales.to(torch.float32)

    def score(rows):
        return (q @ corpus_i8[rows].to(torch.float32).T) * s[rows][None, :]

    return scan_topk(score, queries.shape[0], corpus_i8.shape[0], k, chunk_size, valid_rows,
                     corpus_i8.device)


def _dequant_chunk_int4(chunk: torch.Tensor, chunk_scales: torch.Tensor) -> torch.Tensor:
    """[rows, D/2] packed uint8 + [rows, NB] scales -> bf16 [rows, D]: the
    levels times their block scales, rounded to bf16 (the reference's
    ``_dequant_chunk_int4``)."""
    vals = torch.cat([chunk & 15, chunk >> 4], dim=1).to(torch.float32) - 7.5
    s = chunk_scales.to(torch.float32).repeat_interleave(INT4_BLOCK, dim=1)
    return (vals * s).to(torch.bfloat16)


def topk_mips_int4(queries: torch.Tensor, corpus_q4: torch.Tensor, scales: torch.Tensor,
                   k: int, chunk_size: int = 32768, valid_rows: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked top-k over a packed-int4 corpus with per-block scales: queries
    rounded to bf16, the chunk dequantized to bf16 (:func:`_dequant_chunk_int4`),
    f32 dot products."""
    q = queries.to(torch.bfloat16).to(torch.float32)

    def score(rows):
        return q @ _dequant_chunk_int4(corpus_q4[rows], scales[rows]).to(torch.float32).T

    return scan_topk(score, queries.shape[0], corpus_q4.shape[0], k, chunk_size, valid_rows,
                     corpus_q4.device)
