"""Wrapper of the weight-only 4-bit matmul kernel (K6), beside its plain
version.

``int4_matmul`` (``csrc/int4_matmul.cu``) replaces the Pallas kernel of
``kirag_tpu.ops.pallas_qmm``: ``x [..., in] @ dequant(packed [in/2, out],
scales [in/64, out][, codebook [16]])``. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs :func:`int4_matmul_plain` (a CUDA
kernel cannot run on the CPU). Each call is one launch, cut as :func:`plan`
says, and adds one to ``launch_counts()["int4_matmul"]``.

Format (``kirag_tpu_torch.models.llm._quantize_kernel_int4/_nf4``): packed
row ``i`` holds input rows ``2i`` (low nibble) and ``2i + 1`` (high nibble),
signed values in [-7, 7], or with ``codebook`` unsigned indices into 16
values that are rounded to bf16 when looked up; one f32 scale per
(64-input-row block, output column).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from kirag_tpu_torch.kernels.build import load_library
from kirag_tpu_torch.kernels.common import count_launch, on_cpu, raise_on

SUB = 32              # packed rows per scale block (64 input rows)
TILE_COLS = 128       # output columns per block of the kernel
MAX_TILES = 4         # 8-row tiles of x a block holds: 32 rows
MAX_CLUSTER = 16      # blocks of a cluster (above 8 a non-portable size)
# How far the cluster splits the reduction, by 8-row tiles: while the grid
# has fewer than `blocks` blocks or a block more than `steps` scale blocks,
# unless the grid would pass `most` blocks (linear int4's, NF4's). Fitted to
# phase 7 of chip_smoke.py, which times every cluster size at the 8B
# projections at 1, 4, 16 and 32 rows: on the H100 the rule's size was the
# fastest in 34-35 of the 40 cases and within 1.5% of the fastest in the
# rest. 1, 2 and 4 tiles are measured there; 3 tiles (17-24 rows) is not and
# takes 4 tiles' entry. NF4's lm_head at 1-8 rows is fastest at 2 blocks,
# int4's at 4, hence the two `most`.
SPLIT_RULE = {1: (448, 16, 4096, 2048), 2: (448, 16, 2048, 2048),
              3: (224, 16, 1024, 1024), 4: (224, 16, 1024, 1024)}


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


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch of the kernel is cut, passed whole to it: a grid of
    (col_blocks, cluster, row_blocks) blocks of 128 columns and ``8 * tiles``
    rows; cluster rank r sums scale blocks ``r * steps`` to ``(r + 1) * steps
    - 1``, and the ranks' sums are added in rank order. The kernel refuses a
    plan that does not cover its call exactly."""

    tiles: int      # 8-row tiles of x a block holds (1-4)
    row_blocks: int
    col_blocks: int
    cluster: int
    steps: int

    @property
    def grid(self):
        return (self.col_blocks, self.cluster, self.row_blocks)


@functools.lru_cache(maxsize=1024)
def plan(rows: int, half: int, out_dim: int, nf4: bool) -> Plan:
    """The launch of :func:`int4_matmul` for ``rows`` rows of x over a
    ``[half, out_dim]`` packed weight (NF4 or linear int4): the fewest 8-row
    tiles that hold the rows (more than 32 rows take a block row per 32), and
    a cluster of ``SPLIT_RULE``'s size, whose blocks share the scale blocks
    evenly."""
    if rows < 1 or half < SUB or half % SUB or out_dim < TILE_COLS or out_dim % TILE_COLS:
        raise ValueError(f"no plan for {rows} rows of [{half}, {out_dim}]")
    tiles = min(MAX_TILES, -(-rows // 8))
    row_blocks = -(-rows // (8 * tiles))
    col_blocks = out_dim // TILE_COLS
    n_blocks = half // SUB
    blocks, steps, most_int4, most_nf4 = SPLIT_RULE[tiles]
    most = most_nf4 if nf4 else most_int4
    tiles_total = col_blocks * row_blocks
    cluster = 1
    while (cluster < MAX_CLUSTER and n_blocks % (2 * cluster) == 0
           and tiles_total * 2 * cluster <= most
           and (tiles_total * cluster < blocks or n_blocks // cluster > steps)):
        cluster *= 2
    return Plan(tiles, row_blocks, col_blocks, cluster, n_blocks // cluster)


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
    scales = scales.to(torch.float32).contiguous()
    cb = None if codebook is None else codebook.to(torch.float32).contiguous()
    out = launch(xf, packed.contiguous(), scales, cb,
                 plan(xf.shape[0], half, out_dim, cb is not None))
    return out.reshape(*lead, out_dim)


def launch(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
           codebook: Optional[torch.Tensor], p: Plan) -> torch.Tensor:
    """One launch of the kernel over contiguous CUDA tensors (x 2-d, scales
    and the codebook f32), cut as ``p`` says: :func:`int4_matmul` passes
    :func:`plan`'s, phase 7 of ``chip_smoke.py`` times every cluster size.
    Adds one to ``launch_counts()["int4_matmul"]``."""
    for name, t in (("x", x), ("packed", packed), ("scales", scales), ("codebook", codebook)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    (rows, _), (half, out_dim) = x.shape, packed.shape
    out = torch.empty(rows, out_dim, dtype=x.dtype, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.kirag_int4_matmul(
            x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(), scales.data_ptr(),
            None if codebook is None else codebook.data_ptr(), out.data_ptr(), rows, half,
            out_dim, p.tiles, p.row_blocks, p.col_blocks, p.cluster, p.steps,
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, lib, "int4_matmul")
    count_launch("int4_matmul")
    return out


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
