from kirag_tpu_torch.ops.exact import exact_topk_mips, hier_topk, stable_topk
from kirag_tpu_torch.ops.mips import topk_mips
from kirag_tpu_torch.ops.pooling import cls_pool, l2_normalize, masked_mean_pool

__all__ = [
    "cls_pool",
    "exact_topk_mips",
    "hier_topk",
    "l2_normalize",
    "masked_mean_pool",
    "stable_topk",
    "topk_mips",
]
