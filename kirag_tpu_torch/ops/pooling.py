"""Pooling and normalisation heads of the bi-encoders (port of
:mod:`kirag_tpu.ops.pooling`): masked mean + L2 norm (E5), CLS + L2 norm
(BGE), masked mean without norm (Contriever)."""

from __future__ import annotations

from typing import Optional

import torch


def masked_mean_pool(last_hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid tokens. ``last_hidden``: [..., T, H]; mask: [..., T]."""
    mask = attention_mask.to(last_hidden.dtype)[..., None]
    summed = torch.sum(last_hidden * mask, dim=-2)
    counts = torch.sum(mask, dim=-2)
    counts = torch.where(counts == 0, torch.ones_like(counts), counts)
    return summed / counts


def cls_pool(last_hidden: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First-token (CLS) pooling. ``last_hidden``: [..., T, H]."""
    return last_hidden[..., 0, :]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)
