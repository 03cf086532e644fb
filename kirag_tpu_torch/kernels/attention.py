"""Wrappers of the encoder's flash attention kernels (K3 and its backward),
beside their plain versions.

``flash_attention`` replaces the Pallas TPU flash attention that
``kirag_tpu.models.bert._flash_attention`` calls, a ``jax.custom_vjp`` whose
backward launches two more kernels. Here it is a ``torch.autograd.Function``:

- forward: ``csrc/flash_attention.cu``, which also writes each row's
  ``lse = m + log(l)`` when a gradient will be taken;
- backward: ``csrc/flash_attention_bwd.cu``, one kernel for dK and dV
  (:func:`flash_attention_bwd_dkv`) and one for dQ
  (:func:`flash_attention_bwd_dq`); ``di = rowsum(o * dO)`` in f32 is plain
  torch, as the reference computes it outside its kernels.

On CUDA tensors every wrapper launches its kernel or raises; on CPU tensors
it runs its plain version (a CUDA kernel cannot run on the CPU):
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`. Each
launch adds one to ``launch_counts()[name]`` with ``name`` one of
``flash_attention``, ``flash_attention_bwd_dkv``, ``flash_attention_bwd_dq``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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


def _check_bwd(q, rows, do) -> None:
    """``rows``: the f32 [B, H, T] per-row operands (lse, di) by name."""
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dout must match q ({tuple(q.shape)}, {q.dtype}), got "
                         f"{tuple(do.shape)}, {do.dtype}")
    for name, x in rows.items():
        if x.shape != q.shape[:3] or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, got {x.dtype} "
                             f"{tuple(x.shape)}")


def _aligned_rows(x: torch.Tensor) -> bool:
    """Whether the kernels can read ``x`` by strides: d contiguous and every
    row starting on 16 bytes (their vector reads)."""
    vec = 16 // x.element_size()
    return x.stride(-1) == 1 and not any(s % vec for s in x.stride()[:3]) and not (
        x.data_ptr() % 16)


def _kernel_operands(q, named) -> None:
    """What the kernels take: head_dim 64, T a multiple of 64, rows of 16
    aligned bytes (any strides whose last is 1)."""
    _, _, t, d = q.shape
    if d != KERNEL_HEAD_DIM or t % KERNEL_TILE:
        raise ValueError(f"the flash attention kernels take head_dim {KERNEL_HEAD_DIM} and "
                         f"T a multiple of {KERNEL_TILE}, got head_dim {d}, T {t}")
    for name, x in named.items():
        if not _aligned_rows(x):
            raise ValueError(f"{name} must have contiguous, 16-byte aligned rows "
                             f"(strides {x.stride()})")


def _empty_like_rows(q: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] as a view of a [B, T, H, D] tensor, so ``x.transpose(1, 2)``
    is contiguous for the projection that follows."""
    b, h, t, d = q.shape
    return torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def _strides(*tensors) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(tensors)))(*(s for x in tensors for s in x.stride()[:3]))


def _forward(q, k, v, segment_ids, sm_scale, with_lse: bool):
    """The forward kernel: (out, lse or None)."""
    _kernel_operands(q, {"q": q, "k": k, "v": v})
    b, h, t, _ = q.shape
    lib = load_library()
    seg = _aligned(segment_ids.to(torch.int32))  # copied in bulk, 64 ids a tile
    out = _empty_like_rows(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = lib.kirag_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), int(q.dtype == torch.bfloat16), b, h, t,
            float(sm_scale), _strides(q, k, v, out),
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, lib, "flash_attention")
    count_launch("flash_attention")
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """K3 with its gradient. ``plain`` runs the plain forward and backward on
    any device: the reference the kernels are held against."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, sm_scale, plain):
        need_grad = any(ctx.needs_input_grad[:3])
        if plain or on_cpu(q, k, v, segment_ids):
            out, lse = flash_attention_plain(q, k, v, segment_ids, sm_scale, return_lse=True)
        else:
            out, lse = _forward(q, k, v, segment_ids, sm_scale, with_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, segment_ids, out, lse)
            ctx.sm_scale, ctx.plain = sm_scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, segment_ids, out, lse, do, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Segment-id attention (K3): ``out[b, h, i] = sum_j softmax_j(sm_scale *
    q_i . k_j) v_j`` over the keys with ``segment_ids[b, j] ==
    segment_ids[b, i]``, logits and softmax in f32, ``p.astype(v.dtype) @ v``.

    ``q, k, v`` [B, H, T, D] float32 or bfloat16 (views with any strides whose
    last one is 1, such as slices of a fused QKV projection); ``segment_ids``
    [B, T] integers. Returns [B, H, T, D] in the input dtype; on the card it
    is a view of a [B, T, H, D] tensor, so ``out.transpose(1, 2)`` is
    contiguous. The kernels take D = 64 and T a multiple of 64.
    Differentiable in q, k and v: the backward launches
    :func:`flash_attention_bwd_dkv` and :func:`flash_attention_bwd_dq`.
    """
    _check(q, k, v, segment_ids)
    return _FlashAttention.apply(q, k, v, segment_ids, sm_scale, False)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              segment_ids: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """:func:`flash_attention` through the plain forward and backward on any
    device, the same formulas as the kernels: what ``chip_smoke.py`` holds a
    training step through the kernels against. The port's model never
    calls it."""
    _check(q, k, v, segment_ids)
    return _FlashAttention.apply(q, k, v, segment_ids, sm_scale, True)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segment_ids: torch.Tensor, sm_scale: float,
                          return_lse: bool = False):
    """Plain PyTorch version of the forward kernel, same contract, with the
    [B, H, T, T] logits in memory. ``return_lse`` also returns each row's
    log-sum-exp of its (scaled, same-segment) logits, f32 [B, H, T]."""
    _check(q, k, v, segment_ids)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    logits = torch.where(same, logits * sm_scale, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _bwd_plain(q, k, v, segment_ids, lse, di, do, sm_scale):
    """dq, dk, dv from the residuals, the kernels' formulas written out: P
    recomputed from lse; dV = P^T dO with P rounded to the input dtype; dS =
    P (dO V^T - di) sm_scale; dK = dS^T Q and dQ = dS K with dS rounded to the
    input dtype; f32 products."""
    f32 = torch.float32
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * sm_scale
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    p = torch.where(same, torch.exp(logits - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    ds = p * (dp - di[..., None]) * sm_scale
    p, ds = p.to(q.dtype).to(f32), ds.to(q.dtype).to(f32)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(f32))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(f32))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _di(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    return torch.sum(out.to(torch.float32) * do.to(torch.float32), dim=-1)


def flash_attention_bwd_plain(q, k, v, segment_ids, out, lse, do, sm_scale
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: ``(dq, dk, dv)`` of
    :func:`flash_attention` for the upstream gradient ``do``, from the
    forward's ``out`` and ``lse``."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, {"lse": lse}, do)
    return _bwd_plain(q, k, v, segment_ids, lse, _di(out, do), do, sm_scale)


def flash_attention_bwd(q, k, v, segment_ids, out, lse, do, sm_scale
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` through the two backward kernels (the plain version
    on CPU tensors); ``di = rowsum(out * do)`` in f32 in between."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, {"lse": lse}, do)
    if on_cpu(q, k, v, segment_ids, out, lse, do):
        return flash_attention_bwd_plain(q, k, v, segment_ids, out, lse, do, sm_scale)
    do = do if _aligned_rows(do) else do.contiguous()  # autograd's layout may be any
    di = _di(out, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, segment_ids, lse, di, do, sm_scale)
    return flash_attention_bwd_dq(q, k, v, segment_ids, lse, di, do, sm_scale), dk, dv


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on 16 bytes (the kernels copy 64-row
    slices of it in bulk)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bwd_launch(name, q, k, v, segment_ids, lse, di, do, sm_scale, outs):
    _kernel_operands(q, {"q": q, "k": k, "v": v, "dout": do})
    b, h, t, _ = q.shape
    lib = load_library()
    seg, lse, di = _aligned(segment_ids.to(torch.int32)), _aligned(lse), _aligned(di)
    # strides of q, k, v, dout, dq, dk, dv in turn; the kernel reads its own
    dq, dk, dv = outs.get("dq", q), outs.get("dk", q), outs.get("dv", q)
    with torch.cuda.device(q.device):
        err = getattr(lib, f"kirag_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), lse.data_ptr(),
            di.data_ptr(), do.data_ptr(), *(x.data_ptr() for x in outs.values()),
            int(q.dtype == torch.bfloat16), b, h, t, float(sm_scale),
            _strides(q, k, v, do, dq, dk, dv), torch.cuda.current_stream(q.device).cuda_stream)
    raise_on(err, lib, name)
    count_launch(name)


def flash_attention_bwd_dkv(q, k, v, segment_ids, lse, di, do, sm_scale
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` of :func:`flash_attention` (kernel: one block per key
    tile); ``lse`` from the forward, ``di = rowsum(out * do)``, both f32
    [B, H, T]. Outputs as [B, T, H, D] tensors viewed [B, H, T, D]."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, {"lse": lse, "di": di}, do)
    if on_cpu(q, k, v, segment_ids, lse, di, do):
        return _bwd_plain(q, k, v, segment_ids, lse, di, do, sm_scale)[1:]
    dk, dv = _empty_like_rows(q), _empty_like_rows(q)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, segment_ids, lse, di, do, sm_scale,
                {"dk": dk, "dv": dv})
    return dk, dv


def flash_attention_bwd_dq(q, k, v, segment_ids, lse, di, do, sm_scale) -> torch.Tensor:
    """``dq`` of :func:`flash_attention` (kernel: one block per query tile);
    operands as :func:`flash_attention_bwd_dkv`."""
    _check(q, k, v, segment_ids)
    _check_bwd(q, {"lse": lse, "di": di}, do)
    if on_cpu(q, k, v, segment_ids, lse, di, do):
        return _bwd_plain(q, k, v, segment_ids, lse, di, do, sm_scale)[0]
    dq = _empty_like_rows(q)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, segment_ids, lse, di, do, sm_scale,
                {"dq": dq})
    return dq
