"""Wrapper of the weight-only 4-bit matmul kernel (K6), beside its plain
version.

``int4_matmul`` (``csrc/int4_matmul.cu``) replaces the Pallas kernel of
``kirag_tpu.ops.pallas_qmm``: ``x [..., in] @ dequant(packed [in/2, out],
scales [in/64, out][, codebook [16]])``. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs :func:`int4_matmul_plain` (a CUDA
kernel cannot run on the CPU). Each launch adds one to
``launch_counts()["int4_matmul"]``.

Format (``kirag_tpu_torch.models.llm._quantize_kernel_int4/_nf4``): packed
row ``i`` holds input rows ``2i`` (low nibble) and ``2i + 1`` (high nibble),
signed values in [-7, 7], or with ``codebook`` unsigned indices into 16
values that are rounded to bf16 when looked up; one f32 scale per
(64-input-row block, output column).
"""

from __future__ import annotations

from typing import Optional

import torch

from kirag_tpu_torch.kernels.build import load_library
from kirag_tpu_torch.kernels.common import count_launch, on_cpu, raise_on

SUB = 32              # packed rows per scale block (64 input rows)
KERNEL_COLS = 1024    # output columns per block of the kernel
TARGET_BLOCKS = 528   # four blocks for each of the H100's 132 SMs


def _pick_block(dim: int, candidates) -> Optional[int]:
    for c in candidates:
        if dim % c == 0:
            return c
    return None


def supported(half: int, out_dim: int) -> bool:
    """True for the [in/2, out] shapes the reference's kernel tiles
    (``kirag_tpu/ops/pallas_qmm.py::supported``): both packages send the same
    shapes to their kernels."""
    return (_pick_block(half, (512, 256)) is not None
            and _pick_block(out_dim, (512, 256, 128)) is not None)


def _check(x, packed, scales, codebook) -> None:
    if packed.dim() != 2 or packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8 [in/2, out], got {packed.dtype} "
                        f"{tuple(packed.shape)}")
    half, out_dim = packed.shape
    if x.shape[-1] != 2 * half:
        raise ValueError(f"x last dim {x.shape[-1]} != 2 * packed rows {half}")
    if scales.shape != (half // SUB, out_dim):
        raise ValueError(f"scales must be [{half // SUB}, {out_dim}], got {tuple(scales.shape)}")
    if codebook is not None and codebook.numel() != 16:
        raise ValueError(f"codebook must hold 16 values, got {codebook.numel()}")
    if not supported(half, out_dim):
        raise ValueError(f"unsupported tiling for [in/2={half}, out={out_dim}]")


def _row_tile(rows: int) -> int:
    return 1 if rows == 1 else 2 if rows == 2 else 4


def split_count(rows: int, half: int, out_dim: int) -> int:
    """How many blocks share one output column's reduction: enough for
    ``TARGET_BLOCKS`` blocks, each a whole number of scale blocks."""
    col_blocks = -(-out_dim // KERNEL_COLS)
    tiles = -(-rows // _row_tile(rows))
    return max(1, min(half // SUB, -(-TARGET_BLOCKS // (col_blocks * tiles))))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [..., in] @ dequant(packed, scales[, codebook])`` (K6): per
    64-row block an f32 partial product, times that block's f32 scale, added
    into an f32 sum; the output has x's dtype. ``x`` is float32 or bfloat16,
    ``in == 2 * packed.shape[0]`` (callers pad), and the shape must be one
    :func:`supported` accepts."""
    _check(x, packed, scales, codebook)
    tensors = (x, packed, scales) + (() if codebook is None else (codebook,))
    if on_cpu(*tensors):
        return int4_matmul_plain(x, packed, scales, codebook)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    half, out_dim = packed.shape
    lead = x.shape[:-1]
    xf = x.reshape(-1, 2 * half).contiguous()
    rows = xf.shape[0]
    packed = packed.contiguous()
    scales = scales.to(torch.float32).contiguous()
    cb = None if codebook is None else codebook.to(torch.float32).contiguous()
    for name, t in (("x", xf), ("packed", packed), ("scales", scales), ("codebook", cb)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    n_split = split_count(rows, half, out_dim)
    out = torch.empty(rows, out_dim, dtype=x.dtype, device=x.device)
    partial = (torch.empty(n_split, rows, out_dim, dtype=torch.float32, device=x.device)
               if n_split > 1 else None)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.kirag_int4_matmul(
            xf.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(), scales.data_ptr(),
            None if cb is None else cb.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), rows, half, out_dim, n_split,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, lib, "int4_matmul")
    count_launch("int4_matmul")
    return out.reshape(*lead, out_dim)


def dequant_nibbles(packed: torch.Tensor, codebook: Optional[torch.Tensor] = None):
    """The two weights of every packed byte as f32 [in/2, out] planes (low
    nibble: even input rows, high nibble: odd), each rounded to bf16 as the
    kernels do: signed integers, or codebook values looked up in f32."""
    if codebook is None:
        p = packed.view(torch.int8)
        lo, hi = torch.bitwise_left_shift(p, 4) >> 4, p >> 4  # arithmetic shifts
    else:
        cb = codebook.to(torch.float32)
        lo, hi = cb[(packed & 0xF).long()], cb[(packed >> 4).long()]
    return (lo.to(torch.bfloat16).to(torch.float32), hi.to(torch.bfloat16).to(torch.float32))


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`int4_matmul`, same contract: the
    dequantized planes in memory, one f32 matmul per scale block."""
    _check(x, packed, scales, codebook)
    half, out_dim = packed.shape
    nb = half // SUB
    lead = x.shape[:-1]
    xf = x.reshape(-1, 2 * half).to(torch.float32)
    xe = xf[:, 0::2].reshape(-1, nb, SUB).transpose(0, 1)       # [nb, rows, 32]
    xo = xf[:, 1::2].reshape(-1, nb, SUB).transpose(0, 1)
    lo, hi = dequant_nibbles(packed, codebook)
    part = (torch.bmm(xe, lo.reshape(nb, SUB, out_dim))
            + torch.bmm(xo, hi.reshape(nb, SUB, out_dim)))       # [nb, rows, out] f32
    out = (part * scales.to(torch.float32)[:, None, :]).sum(0)
    return out.to(x.dtype).reshape(*lead, out_dim)
