"""What every kernel wrapper shares: launch counts, device dispatch and the
check of a launch's CUDA error.

Each wrapper adds one to its kernel's count where it launches the kernel and
nowhere else, so a run can show which kernels its path went through.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

_counts_lock = threading.Lock()
_launches: Dict[str, int] = {"stream_capture": 0, "gather_groups": 0,
                             "stream_capture_int8": 0, "gather_groups_int8": 0,
                             "stream_capture_int4": 0, "gather_groups_int4": 0,
                             "stream_capture_pq4": 0, "gather_groups_pq4": 0,
                             "score_gmax": 0, "score_gmax_int8": 0,
                             "score_gmax_int4": 0, "score_gmax_pq4": 0,
                             "score_gather": 0, "cap_assemble": 0, "window_merge": 0,
                             "group_max": 0, "group_max_int8": 0, "group_max_int4": 0,
                             "flash_attention": 0, "flash_attention_bwd_dkv": 0,
                             "flash_attention_bwd_dq": 0, "int4_matmul": 0}
_shapes: Dict[str, Dict[str, int]] = {}


def launch_counts() -> Dict[str, int]:
    with _counts_lock:
        return dict(_launches)


def launch_shapes() -> Dict[str, Dict[str, int]]:
    """The launches since the last reset by kernel and by the shape its
    wrapper named (the wrappers that name one)."""
    with _counts_lock:
        return {name: dict(by) for name, by in _shapes.items()}


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _launches:
            _launches[name] = 0
        _shapes.clear()


def count_launch(name: str, shape: Optional[str] = None) -> None:
    with _counts_lock:
        _launches[name] += 1
        if shape is not None:
            by = _shapes.setdefault(name, {})
            by[shape] = by.get(shape, 0) + 1


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (the wrapper runs its plain version), False for
    CUDA tensors (it launches its kernel); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def raise_on(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.kirag_error_string(err).decode()} (cudaError {err})")
