from kirag_tpu_torch.ops.approx import approx_topk_mips, grouped_max_scores
from kirag_tpu_torch.ops.exact import exact_topk_mips, hier_topk, stable_topk, topk_lastdim
from kirag_tpu_torch.ops.mips import topk_mips, topk_mips_onepass
from kirag_tpu_torch.ops.pooling import cls_pool, l2_normalize, masked_mean_pool
from kirag_tpu_torch.ops.pq import (
    decode_pq,
    encode_pq,
    pq_level_table,
    resolve_subquantizers,
    train_pq,
)
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
    "decode_pq",
    "dequantize_rows_int4",
    "encode_pq",
    "exact_topk_mips",
    "grouped_max_scores",
    "hier_topk",
    "l2_normalize",
    "masked_mean_pool",
    "pq_level_table",
    "quantize_rows_int4",
    "quantize_rows_int4_torch",
    "quantize_rows_int8",
    "quantize_rows_int8_torch",
    "resolve_subquantizers",
    "stable_topk",
    "topk_lastdim",
    "topk_mips",
    "topk_mips_int4",
    "topk_mips_int8",
    "topk_mips_onepass",
    "train_pq",
]
