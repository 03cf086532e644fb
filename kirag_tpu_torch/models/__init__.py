from kirag_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_encode,
    config_from_hf,
    convert_hf_state_dict,
    params_from_jax,
)
from kirag_tpu_torch.models.encoders import (
    ENCODER_POOLING,
    RETRIEVER_NAME_TO_ENCODER,
    Encoder,
    load_encoder,
)

__all__ = [
    "BertConfig",
    "BertModel",
    "bert_encode",
    "config_from_hf",
    "convert_hf_state_dict",
    "params_from_jax",
    "ENCODER_POOLING",
    "RETRIEVER_NAME_TO_ENCODER",
    "Encoder",
    "load_encoder",
]
