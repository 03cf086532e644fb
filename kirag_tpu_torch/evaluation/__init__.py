from kirag_tpu_torch.evaluation.metrics import (
    ems,
    exact_match_score,
    f1_score,
    has_answer,
    normalize_answer,
)

__all__ = ["normalize_answer", "exact_match_score", "ems", "f1_score", "has_answer"]
