from kirag_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_encode,
    config_from_hf,
    convert_hf_state_dict,
    param_shardings,
    params_from_jax,
    shard_bert_model,
)
from kirag_tpu_torch.models.encoders import (
    ENCODER_POOLING,
    RETRIEVER_NAME_TO_ENCODER,
    Encoder,
    load_encoder,
)
from kirag_tpu_torch.models.llm import (
    LlamaConfig,
    TorchLlamaBackend,
    alloc_prefix_pool,
    greedy_decode_prefixed,
    write_prefix_pool,
)
from kirag_tpu_torch.models.speculative import (
    speculative_decode,
    speculative_resume,
    speculative_start,
)

__all__ = [
    "BertConfig",
    "BertModel",
    "bert_encode",
    "config_from_hf",
    "convert_hf_state_dict",
    "param_shardings",
    "params_from_jax",
    "shard_bert_model",
    "ENCODER_POOLING",
    "RETRIEVER_NAME_TO_ENCODER",
    "Encoder",
    "load_encoder",
    "LlamaConfig",
    "TorchLlamaBackend",
    "alloc_prefix_pool",
    "greedy_decode_prefixed",
    "write_prefix_pool",
    "speculative_decode",
    "speculative_resume",
    "speculative_start",
]
