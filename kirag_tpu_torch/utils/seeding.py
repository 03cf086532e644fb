"""Deterministic seeding of Python, numpy and torch (port of
:mod:`kirag_tpu.utils.seeding`, whose JAX key becomes a torch Generator)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed the global RNGs of Python, numpy and torch (every device) and
    return a CPU ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
