from kirag_tpu_torch.training.loader import DataLoader
from kirag_tpu_torch.training.trainer import AdamW, BaseTrainer, TrainerConfig, make_optimizer
from kirag_tpu_torch.training.aligner import AlignerTrainer, in_batch_contrastive_loss

__all__ = [
    "DataLoader",
    "AdamW",
    "BaseTrainer",
    "TrainerConfig",
    "make_optimizer",
    "AlignerTrainer",
    "in_batch_contrastive_loss",
]
