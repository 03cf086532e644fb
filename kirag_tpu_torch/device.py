"""Device policy of the port.

Every module takes its device as an explicit argument; nothing moves a tensor
to the GPU by itself. The policy is:

- ``require_cuda()`` returns the first CUDA device or raises. Code that
  measures the card (``chip_smoke.py``) calls it and never falls back to the
  CPU.
- On the CPU the kernels' wrappers run their plain versions (see
  :mod:`kirag_tpu_torch.kernels.exact`); on a CUDA device they launch the
  CUDA kernels or raise.
- No TF32 flag is set anywhere in the package. Float32 parity with the JAX
  package is claimed only with both ``torch.backends.cuda.matmul.allow_tf32``
  (PyTorch's default: False) and ``torch.backends.cudnn.allow_tf32``
  (default: True, unused by this package, which runs no convolution) False;
  :func:`tf32_flags` reports them so a caller can state and check them.
"""

from __future__ import annotations

from typing import Dict

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when there is no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this needs an NVIDIA GPU "
                           f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    return torch.device("cuda", 0)


def tf32_flags() -> Dict[str, bool]:
    return {
        "torch.backends.cuda.matmul.allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "torch.backends.cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32),
    }
