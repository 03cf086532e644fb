"""Hand-written CUDA kernels of the port, their wrappers and plain versions."""

from kirag_tpu_torch.kernels.approx import group_max, group_max_plain
from kirag_tpu_torch.kernels.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_reference,
)
from kirag_tpu_torch.kernels.build import build, load_library
from kirag_tpu_torch.kernels.common import launch_counts, launch_shapes, reset_launch_counts
from kirag_tpu_torch.kernels.exact import (
    cap_assemble,
    cap_assemble_plain,
    gather_groups,
    gather_groups_plain,
    pq_kernel_geometry_error,
    quant_scores,
    score_gather,
    score_gather_plain,
    score_gmax,
    score_gmax_plain,
    stream_capture,
    stream_capture_plain,
    window_merge,
    window_merge_plain,
)
from kirag_tpu_torch.kernels.qmm import int4_matmul, int4_matmul_plain

__all__ = [
    "build",
    "cap_assemble",
    "cap_assemble_plain",
    "load_library",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "flash_attention_reference",
    "gather_groups",
    "gather_groups_plain",
    "group_max",
    "group_max_plain",
    "int4_matmul",
    "int4_matmul_plain",
    "launch_counts",
    "launch_shapes",
    "pq_kernel_geometry_error",
    "quant_scores",
    "reset_launch_counts",
    "score_gather",
    "score_gather_plain",
    "score_gmax",
    "score_gmax_plain",
    "stream_capture",
    "stream_capture_plain",
    "window_merge",
    "window_merge_plain",
]
