from kirag_tpu_torch.models.bert import BertConfig, BertModel, bert_encode, params_from_jax
from kirag_tpu_torch.models.encoders import ENCODER_POOLING, Encoder

__all__ = [
    "BertConfig",
    "BertModel",
    "bert_encode",
    "params_from_jax",
    "ENCODER_POOLING",
    "Encoder",
]
