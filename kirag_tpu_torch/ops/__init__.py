from kirag_tpu_torch.ops.approx import approx_topk_mips, grouped_max_scores
from kirag_tpu_torch.ops.exact import exact_topk_mips, hier_topk, stable_topk
from kirag_tpu_torch.ops.mips import topk_mips
from kirag_tpu_torch.ops.pooling import cls_pool, l2_normalize, masked_mean_pool
from kirag_tpu_torch.ops.quantized import (
    dequantize_rows_int4,
    quantize_rows_int4,
    quantize_rows_int4_torch,
    quantize_rows_int8,
    quantize_rows_int8_torch,
    topk_mips_int4,
    topk_mips_int8,
)

__all__ = [
    "approx_topk_mips",
    "cls_pool",
    "dequantize_rows_int4",
    "exact_topk_mips",
    "grouped_max_scores",
    "hier_topk",
    "l2_normalize",
    "masked_mean_pool",
    "quantize_rows_int4",
    "quantize_rows_int4_torch",
    "quantize_rows_int8",
    "quantize_rows_int8_torch",
    "stable_topk",
    "topk_mips",
    "topk_mips_int4",
    "topk_mips_int8",
]
