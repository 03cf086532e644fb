"""Wrapper of the encoder's flash attention kernel (K3), beside its plain
version.

``flash_attention`` (``csrc/flash_attention.cu``) replaces the Pallas TPU
flash attention that ``kirag_tpu.models.bert._flash_attention`` calls. On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`flash_attention_plain` (a CUDA kernel cannot run on the CPU). Each
launch adds one to ``launch_counts()["flash_attention"]``.
"""

from __future__ import annotations

import ctypes

import torch

from kirag_tpu_torch.kernels.build import load_library
from kirag_tpu_torch.kernels.common import count_launch, on_cpu, raise_on

KERNEL_HEAD_DIM = 64
KERNEL_TILE = 64  # queries per block and keys per staged tile


def _check(q, k, v, segment_ids) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be one [B, H, T, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    b, _, t, _ = q.shape
    if segment_ids.shape != (b, t):
        raise ValueError(f"segment_ids must be [{b}, {t}], got {tuple(segment_ids.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Segment-id attention (K3): ``out[b, h, i] = sum_j softmax_j(sm_scale *
    q_i . k_j) v_j`` over the keys with ``segment_ids[b, j] ==
    segment_ids[b, i]``, logits and softmax in f32, ``p.astype(v.dtype) @ v``.

    ``q, k, v`` [B, H, T, D] float32 or bfloat16 (views with any strides whose
    last one is 1, such as slices of a fused QKV projection); ``segment_ids``
    [B, T] integers. Returns [B, H, T, D] in the input dtype; on the card it
    is a view of a [B, T, H, D] tensor, so ``out.transpose(1, 2)`` is
    contiguous. The kernel takes D = 64 and T a multiple of 64.
    """
    _check(q, k, v, segment_ids)
    if on_cpu(q, k, v, segment_ids):
        return flash_attention_plain(q, k, v, segment_ids, sm_scale)
    b, h, t, d = q.shape
    if d != KERNEL_HEAD_DIM or t % KERNEL_TILE:
        raise ValueError(f"the flash attention kernel takes head_dim {KERNEL_HEAD_DIM} and "
                         f"T a multiple of {KERNEL_TILE}, got head_dim {d}, T {t}")
    vec = 16 // q.element_size()  # elements per 16-byte vector read
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} must have contiguous, 16-byte aligned rows "
                             f"(strides {x.stride()})")
    lib = load_library()
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.kirag_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, t, float(sm_scale), strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, lib, "flash_attention")
    count_launch("flash_attention")
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segment_ids: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`, same contract, with
    the [B, H, T, T] logits in memory."""
    _check(q, k, v, segment_ids)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    logits = torch.where(same, logits * sm_scale, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
